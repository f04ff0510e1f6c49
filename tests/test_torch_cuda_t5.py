"""T5 and ViT on the card.

- the fused-CE kernels (#8-#10) at T5-v1.1-base's head (N 2048, e 768, V
  32128 = 251 x 128, bf16, every sixteenth label -100) against their plain
  versions;
- one fp32 step (TF32 off) of T5-v1.1-base's width at 1 + 1 layers with
  `seq2seq_loss_fn_fused` against one with `seq2seq_loss_fn`, untied and
  tied: loss and global gradient norm agree and each fused-CE kernel ran
  once;
- a tiny fp32 ViT's logits on the card equal the CPU's from the same weights
  within summation order.

Every test needs an NVIDIA Hopper GPU and skips elsewhere. The file imports
nothing of JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_t5.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# the fused-CE bars of tests/test_torch_cuda_kernels.py: lse and ll (fp32 rows)
# |err| <= 1e-4 + 1e-5 |plain|; bf16 dH and dW |err| <= 1e-2 |plain| + 1e-3
# max|plain| (dlogits rounded to bf16 before the products, each output once)
ROW_TOL = (1e-4, 1e-5)
BF16_TOL = (1e-2, 1e-3)
# fp32 step, fused against dense head: the same fp32 arithmetic in another
# order (chip_smoke.py's TRAIN_LOSS_ATOL and TRAIN_GRAD_NORM_RTOL)
LOSS_ATOL = 1e-4
GRAD_NORM_RTOL = 1e-3
VIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def card():
    from accelerate_tpu_torch.utils.environment import on_hopper

    if not on_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    from accelerate_tpu_torch.ops import fused_ce as fc

    return (fc.fused_ce_fwd.launches, fc.fused_ce_dh.launches, fc.fused_ce_dw.launches)


def test_fused_ce_kernels_at_the_t5_head(card):
    from accelerate_tpu_torch.ops import fused_ce as fc

    n, v, e = 2048, 32128, 768
    g = torch.Generator(device=card).manual_seed(0)
    h = torch.randn(n, e, generator=g, device=card).to(torch.bfloat16)
    w = (torch.randn(v, e, generator=g, device=card) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device=card, dtype=torch.int32)
    mask = torch.arange(n, device=card) % 16 != 15
    labels = torch.where(mask, labels, 0)
    g_lse = mask.float() / mask.sum()
    before = _counts()
    lse, ll = fc.fused_ce_fwd(h, w, labels)
    lse_ref, ll_ref = fc.fused_ce_forward_reference(h, w, labels)
    bwd = (h, w, labels, lse_ref, g_lse, -g_lse)
    dh, dw = fc.fused_ce_dh(*bwd), fc.fused_ce_dw(*bwd)
    torch.cuda.synchronize()
    assert tuple(b + 1 for b in before) == _counts()
    for got, want in ((lse, lse_ref), (ll, ll_ref)):
        assert ((got - want).abs() <= ROW_TOL[0] + ROW_TOL[1] * want.abs()).all()
    for got, want in ((dh, fc.fused_ce_dh_reference(*bwd)), (dw, fc.fused_ce_dw_reference(*bwd))):
        want = want.float()
        bar = BF16_TOL[0] * want.abs() + BF16_TOL[1] * want.abs().max()
        assert ((got.float() - want).abs() <= bar).all(), (got.float() - want).abs().max()


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fp32_fused_step_equals_dense(card, tied):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.t5 import (
        T5Config,
        T5ForConditionalGeneration,
        seq2seq_loss_fn,
        seq2seq_loss_fn_fused,
        shift_tokens_right,
    )

    cfg = T5Config.base(num_layers=1, num_decoder_layers=1, dtype=torch.float32,
                        tie_word_embeddings=tied)
    g = torch.Generator(device=card).manual_seed(1)
    labels = torch.randint(1, cfg.vocab_size, (2, 64), generator=g, device=card)
    labels[1, 40:] = -100
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (2, 256), generator=g, device=card),
             "decoder_input_ids": shift_tokens_right(labels), "labels": labels,
             "decoder_attention_mask": (labels != -100).long()}
    out = {}
    for fn in (seq2seq_loss_fn, seq2seq_loss_fn_fused):
        model = T5ForConditionalGeneration(cfg, seed=0)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4))
        step = acc.make_train_step(fn, max_grad_norm=1e30)
        before = _counts()
        loss = step(batch).item()
        out[fn.__name__] = (loss, step.grad_norm.item(),
                            tuple(a - b for a, b in zip(_counts(), before)))
    (loss_p, norm_p, counts_p), (loss_f, norm_f, counts_f) = (out["seq2seq_loss_fn"],
                                                              out["seq2seq_loss_fn_fused"])
    assert counts_p == (0, 0, 0) and counts_f == (1, 1, 1)
    assert abs(loss_f - loss_p) <= LOSS_ATOL, (loss_f, loss_p)
    assert abs(norm_f - norm_p) <= GRAD_NORM_RTOL * norm_p, (norm_f, norm_p)


def test_vit_logits_on_the_card_equal_the_cpu(card):
    from accelerate_tpu_torch.models.vit import ViTConfig, ViTForImageClassification

    cfg = ViTConfig.tiny(dtype=torch.float32)
    cpu = ViTForImageClassification(cfg, device="cpu", seed=2)
    gpu = ViTForImageClassification(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    images = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, got = cpu(images), gpu(images.to(card)).cpu()
    torch.testing.assert_close(got, want, atol=VIT_ATOL, rtol=0)
