"""The training runs one rank of `tests/test_torch_ddp_train.py`'s worlds
makes (gloo on the CPU; see `tests/torch_world.py`), from the inputs the
test wrote (the reference's tiny GPT-2 weights under the port's names, the
global batches, PowerSGD's initial Q, the MLP's weights): GPT-2 tiny fp32
data-parallel steps plain, with gradient accumulation and through the
``bf16``, ``fp16`` and ``power_sgd`` hooks; the imperative loop beside
``make_train_step``; PowerSGD with its factors carried in bf16; Local SGD
on the by_feature MLP. Each records its losses and this rank's final
parameters. Imports nothing of JAX."""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import Recorder  # noqa: E402

LR = 1e-2


def run(inputs: str, out: str) -> None:
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.examples.by_feature import _common
    from accelerate_tpu_torch.local_sgd import LocalSGD, make_local_train_step
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn
    from accelerate_tpu_torch.parallel.compression import CommHookConfig
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    r, n = state.process_index, state.num_processes
    data = torch.load(inputs, weights_only=False)
    rec = Recorder(Path(out), r)

    def mine(ids):  # this rank's slice of a global batch
        per = ids.shape[0] // n
        return {"input_ids": torch.from_numpy(ids[r * per:(r + 1) * per]).long()}

    def gpt2(k: int = 1):
        model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, attention_impl="xla"),
                           device="cpu")
        model.load_state_dict(data["gpt2"])
        acc = Accelerator(mixed_precision="no", gradient_accumulation_steps=k)
        model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR,
                                                          weight_decay=1e-4))
        return acc, model, opt

    def params(model):
        return {name: p.detach().clone() for name, p in model.module.named_parameters()}

    def train(hook=None, k=1, wrapper="no"):
        acc, model, opt = gpt2(k)
        q = data["q"] if hook == "power_sgd" else None
        cfg = CommHookConfig(hook, start_powerSGD_iter=1, wrapper=wrapper) if hook else None
        step = acc.make_train_step(lm_loss_fn, comm_hook=cfg, comm_q=q)
        losses = [step(mine(ids)).item() for ids in data["batches"][:3 * k]]
        return {"losses": losses, "params": params(model), "updates": opt.num_updates}

    for case in ("plain", "bf16", "fp16", "power_sgd"):
        rec.check(case, lambda: train(None if case == "plain" else case))
    if n == 2:
        rec.check("plain_k2", lambda: train(None, k=2))
        rec.check("power_sgd_bf16_wrapper", lambda: train("power_sgd", wrapper="bf16"))

        def imperative():
            acc, model, opt = gpt2()
            losses = []
            for ids in data["batches"][:3]:
                with acc.accumulate(model):
                    losses.append(acc.backward(lm_loss_fn, mine(ids)).item())
                    opt.step()
                    opt.zero_grad()
            return {"losses": losses, "params": params(model)}

        rec.check("imperative", imperative)

    def local_sgd():
        model = _common.make_model(data["mlp_seed"], "cpu")
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        local_step, sync, replicate, unreplicate = make_local_train_step(_common.loss_fn, model, opt)
        island = replicate()
        losses = []
        with LocalSGD(sync_fn=sync, local_sgd_steps=2) as lsgd:
            for batch in data["mlp_batches"]:
                per = batch["x"].shape[0] // n
                local = {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}
                island, loss = local_step(island, local)
                island = lsgd.step(island)
                losses.append(loss.item())
        island = sync(island)
        return {"losses": losses, "params": unreplicate(island)}

    rec.check("local_sgd", local_sgd)
    state.wait_for_everyone()
    rec.save()
    state.shutdown()
