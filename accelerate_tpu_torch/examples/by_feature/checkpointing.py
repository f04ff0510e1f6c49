"""Feature: checkpoint and resume (the reference's `by_feature/checkpointing.py`).

``save_state`` writes model, optimizer, loaders, RNG and step into a
rotating ``checkpoints/checkpoint_<i>`` directory (``total_limit=2``);
``load_state`` restores it, and ``skip_first_batches`` resumes inside an
epoch. The run ends by zeroing the weights and restoring the latest
checkpoint, which must give the same accuracy.

Run:
    python -m accelerate_tpu_torch.examples.by_feature.checkpointing --tiny --project_dir DIR
    python -m accelerate_tpu_torch.examples.by_feature.checkpointing --tiny --project_dir DIR \\
        --resume_from_checkpoint DIR/checkpoints/checkpoint_1
"""

from __future__ import annotations

import tempfile

import torch

from ...accelerator import Accelerator, ProjectConfiguration
from ...data_loader import DataLoaderShard, skip_first_batches
from ...utils.random import set_seed
from ._common import base_parser, evaluate, loss_fn, make_batches, make_model


def main(argv: list[str] | None = None) -> dict:
    parser = base_parser()
    parser.add_argument("--resume_from_checkpoint", default=None)
    args = parser.parse_args(argv)
    set_seed(args.seed)
    project_dir = args.project_dir or tempfile.mkdtemp(prefix="ckpt_example_")
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision, device=args.device,
        project_config=ProjectConfiguration(project_dir=project_dir,
                                            automatic_checkpoint_naming=True, total_limit=2))
    n_train = 4 if args.tiny else 12
    model = make_model(args.seed, accelerator.device)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        DataLoaderShard(make_batches(n_train, args.batch_size)),
        DataLoaderShard(make_batches(4, args.batch_size, seed=1)))
    step = accelerator.make_train_step(loss_fn)
    if args.resume_from_checkpoint:
        accelerator.load_state(args.resume_from_checkpoint)

    losses, saved = [], []
    for epoch in range(args.num_epochs):
        dl = train_dl
        if args.resume_from_checkpoint and epoch == 0:
            dl = skip_first_batches(train_dl, 2)  # resume past 2 batches
        for batch in dl:
            losses.append(float(step(batch)))
        saved.append(accelerator.save_state())  # checkpoints/checkpoint_<n>, 2 kept
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {epoch}: loss={losses[-1]:.4f} accuracy={acc:.3f}")

    # the round trip: zero the weights, restore the latest checkpoint
    before = evaluate(accelerator, model, eval_dl)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    restored = accelerator.load_state()
    after = evaluate(accelerator, model, eval_dl)
    accelerator.print(f"restore parity: accuracy {before:.3f} == {after:.3f}")
    assert abs(before - after) < 1e-6
    return {"losses": losses, "accuracy": after, "saved": saved, "restored": restored,
            "project_dir": project_dir}


if __name__ == "__main__":
    main()
