"""Big-model streaming on the card: `big_modeling.BlockwiseModel` with its
blocks on the device, in pinned host memory and on disk, against the
resident model.

- streamed equals resident: a Llama and a Mixtral of moderate width, fp32,
  TF32 off, dispatched over the three tiers (and a split block) give the
  full model's logits, twice;
- the peak-memory bound: a bf16 model's peak allocated memory during a
  streamed forward stays within what was allocated before it, the streamed
  bytes of two consecutive blocks and the resident forward's activations;
- a streamed block whose compute is held back (``torch.cuda._sleep`` on
  the compute stream before each block) still reads the right weights: the
  copy stream's tensors are not reused while the compute stream reads them;
- `cpu_offload_with_hook` over two models: entering the second frees the
  first's device copies, and ``offload()`` brings memory back within 1 MiB;
- ``device:i`` past the card count raises.

Every test needs an NVIDIA Hopper GPU and skips elsewhere. The file imports
nothing of JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_big_modeling.py
"""

import tempfile

import pytest
import torch

from accelerate_tpu_torch import big_modeling as bm
from accelerate_tpu_torch.models import llama, mixtral

pytestmark = pytest.mark.cuda

# the same kernels in the same order on the same weights: streamed and
# resident logits are expected equal; the bar is the phase's fp32 one
STREAM_ATOL = 1e-5
MIB = 1 << 20


@pytest.fixture(scope="module")
def card():
    from accelerate_tpu_torch.utils.environment import on_hopper

    if not on_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(family, dtype, **kw):
    if family == "llama":
        cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=512, intermediate_size=1376,
                                num_layers=4, num_heads=8, num_kv_heads=2, dtype=dtype,
                                param_dtype=dtype, max_position_embeddings=256, **kw)
        return cfg, llama.LlamaForCausalLM(cfg, seed=1), llama.llama_blockwise, \
            llama.llama_blockwise_state_dict
    cfg = mixtral.MixtralConfig(vocab_size=1024, hidden_size=512, intermediate_size=768,
                                num_layers=4, num_heads=8, num_kv_heads=2, num_experts=4,
                                dtype=dtype, param_dtype=dtype, max_position_embeddings=256, **kw)
    return cfg, mixtral.MixtralForCausalLM(cfg, seed=1), mixtral.mixtral_blockwise, \
        mixtral.mixtral_blockwise_state_dict


MAPS = {
    "tiers": {"embed": "device", "layer_0": "cpu", "layer_1": "disk", "layer_2": "cpu",
              "layer_3": "device", "head": "disk"},
    "split": {"embed": "device", "layer_0/attn": "cpu", "layer_0/input_norm": "device",
              "layer_0/post_attn_norm": "disk", "layer_1": "cpu", "layer_2": "disk",
              "layer_3": "cpu", "head": "device"},
}


@pytest.mark.parametrize("dmap", sorted(MAPS))
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_streamed_equals_resident(card, family, dmap):
    cfg, model, bw_fn, sd_fn = _model(family, torch.float32, attention_impl="flash")
    ids = torch.randint(0, cfg.vocab_size, (1, 200), device=card,
                        generator=torch.Generator(card).manual_seed(0))
    with torch.no_grad():
        want = model(ids)
    dmap = dict(MAPS[dmap])
    if "layer_0/attn" in dmap:  # the rest of layer_0 on disk
        key = "mlp" if family == "llama" else "moe"
        dmap[f"layer_0/{key}"] = "disk"
    with tempfile.TemporaryDirectory() as off, torch.no_grad():
        bw = bm.dispatch_model(bw_fn(cfg), dmap, sd_fn(model.state_dict()), offload_dir=off)
        for _ in range(2):
            got = bw(ids)
            torch.testing.assert_close(got, want, atol=STREAM_ATOL, rtol=0)
        assert bw.streamed_bytes["cpu"] > 0 and bw.streamed_bytes["disk"] > 0


def test_peak_memory_bound(card):
    cfg, model, bw_fn, sd_fn = _model("mixtral", torch.bfloat16, attention_impl="flash")
    ids = torch.randint(0, cfg.vocab_size, (1, 256), device=card,
                        generator=torch.Generator(card).manual_seed(1))
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        want = model(ids)
        activations = torch.cuda.max_memory_allocated() - before
    sd = {k: v.to("cpu") for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    dmap = {"embed": "device", "layer_0": "cpu", "layer_1": "disk", "layer_2": "cpu",
            "layer_3": "disk", "head": "cpu"}
    with tempfile.TemporaryDirectory() as off, torch.no_grad():
        bw = bm.dispatch_model(bw_fn(cfg), dmap, sd_fn(sd), offload_dir=off)
        bw(ids)  # first call: the staging buffer and the copy stream
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = bw(ids)
        peak = torch.cuda.max_memory_allocated() - base
        pair_bytes, pair_tensors = bw.streamed_pair()
    # each tensor's block may be up to 1 MiB larger than its bytes (the
    # caching allocator does not split off a remainder below that)
    bound = pair_bytes + activations + pair_tensors * MIB
    assert torch.equal(got, want)
    assert peak <= bound, (peak, pair_bytes, activations)
    assert peak >= pair_bytes // 2  # the streamed blocks were on the card


def test_held_back_compute_reads_the_right_weights(card):
    """Each block's compute starts after a long sleep on the compute stream,
    so the copy stream runs far ahead: its tensors must not be reused while
    the compute stream still reads them."""
    cfg, model, bw_fn, sd_fn = _model("llama", torch.float32, attention_impl="flash")
    ids = torch.randint(0, cfg.vocab_size, (1, 128), device=card,
                        generator=torch.Generator(card).manual_seed(2))
    with torch.no_grad():
        want = model(ids)
    names = [f"layer_{i}" for i in range(cfg.num_layers)]
    with tempfile.TemporaryDirectory() as off, torch.no_grad():
        bw = bm.dispatch_model(bw_fn(cfg), {"embed": "device", **{n: "cpu" for n in names},
                                            "head": "disk"}, sd_fn(model.state_dict()),
                               offload_dir=off)

        def slow(fn):
            def run(p, x):
                torch.cuda._sleep(50_000_000)  # about 25 ms of spinning
                return fn(p, x)
            return run

        bw.block_fns = [(n, slow(fn)) for n, fn in bw.block_fns]
        for _ in range(3):
            torch.testing.assert_close(bw(ids), want, atol=STREAM_ATOL, rtol=0)


def test_cpu_offload_with_hook_frees_the_previous_model(card):
    cfg, model, bw_fn, sd_fn = _model("llama", torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (1, 64), device=card)
    sd = sd_fn({k: v.to("cpu").pin_memory() for k, v in model.state_dict().items()})
    model_bytes = sum(v.numel() * v.element_size() for v in model.state_dict().values())
    del model
    torch.cuda.empty_cache()
    with torch.no_grad():
        m1, hook1 = bm.cpu_offload_with_hook(bw_fn(cfg), sd)
        m2, hook2 = bm.cpu_offload_with_hook(bw_fn(cfg), sd, prev_module_hook=hook1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        a = m1(ids)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - base >= model_bytes
        torch.cuda.reset_peak_memory_stats()
        b = m2(ids)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < 1.5 * model_bytes
        assert not m1._cache
        hook2.offload()
        del a, b
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert abs(torch.cuda.memory_allocated() - base) <= MIB


def test_device_index_past_the_card_count_raises(card):
    cfg, model, bw_fn, sd_fn = _model("llama", torch.float32)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="different topology"):
        bm.dispatch_model(bw_fn(cfg), {"embed": f"device:{n}", "layer_0": "cpu", "layer_1": "cpu",
                                       "layer_2": "cpu", "layer_3": "cpu", "head": "cpu"},
                          sd_fn(model.state_dict()))
