"""Weight-only quantization, blockwise int8 and 4-bit (nf4 / fp4): the port of
`accelerate_tpu.utils.quantization`.

A weight is stored as a `QuantizedTensor`: a packed integer payload and one
fp32 absmax scale per ``block_size`` consecutive elements of the flattened
weight. int8 is symmetric absmax (``round(x / absmax * 127)``); 4-bit maps each
element to the nearest entry of the NF4 codebook (the 16 quantiles of a
standard normal scaled to [-1, 1], from QLoRA) or of the FP4 e2m1 value set,
and packs two codes per byte, the even element in the high nibble. The
payload and scales equal the reference's byte for byte.

Layout: a quantized projection keeps the reference's ``[in, out]`` kernel
layout (``x @ W``), so it is quantized from ``nn.Linear.weight.T``; its
64-element blocks then run along the output axis, as the reference's do, and
the plane packing of `ops.nf4_matmul` applies unchanged. Embedding tables
keep their ``[num, dim]`` layout.

`quantize_module` swaps layers where the reference wraps the forward: it
returns a copy of the module in which every eligible ``nn.Linear`` and
``nn.Embedding`` is a `QuantizedLinear` or `QuantizedEmbedding` over a
`QuantizedTensor`, and so is every eligible bare table a module names in its
``quantizable_tables`` (Llama's ``embed_tokens`` and ``lm_head``). Dense
leaves (biases, norms) are shared with the caller's module, which is never
changed. The model reads quantized weights itself (`models.gpt2`,
`models.llama`): an nf4 projection through the `ops.nf4_matmul` kernel,
every other one through `dequantize`. So the reference's ``QuantizedModule``
shim, which dequantizes every leaf on entry to the forward, has no
counterpart: the swapped layers play its role. `quantize_model` makes the
swap in place on a model (what ``Accelerator.prepare`` returns is the model
itself), and `load_and_quantize_model` fills a model from a safetensors
checkpoint, quantizing on the card leaf by leaf (`quantize(on_device=True)`,
the pass of `quantize_params(on_device=True)`), so the dense weights never
sit on the card whole.
"""

from __future__ import annotations

import copy
import functools
import os
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from .environment import resolve_device
from .safetensors_io import load_safetensors_checkpoint, to_device

# NF4: the 16 quantiles of a standard normal scaled to [-1, 1] (QLoRA).
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# FP4 (e2m1): sign x {0, .0625, 8, 12, 4, 6, 2, 3} / 12, bitsandbytes' value set.
FP4_CODE = np.array(
    [
        0.0, 0.0052, 0.6667, 1.0, 0.3333, 0.5, 0.1667, 0.25,
        -0.0, -0.0052, -0.6667, -1.0, -0.3333, -0.5, -0.1667, -0.25,
    ],
    dtype=np.float32,
)


def _codebook(quant_type: str) -> np.ndarray:
    return NF4_CODE if quant_type == "nf4" else FP4_CODE


def _search_tables(quant_type: str) -> tuple[np.ndarray, np.ndarray]:
    """(decision midpoints of the sorted codebook, codebook index of each
    sorted entry): the nearest-code search of the reference's host path.
    fp4's bit-pattern order is unsorted, so codes map back through argsort."""
    code = _codebook(quant_type)
    order = np.argsort(code).astype(np.uint8)
    sorted_code = code[order]
    return (sorted_code[1:] + sorted_code[:-1]) * 0.5, order


@dataclass
class QuantizationConfig:
    """The reference's ``QuantizationConfig``: ``load_in_8bit`` or
    ``load_in_4bit`` picks the payload width, ``quant_type`` the 4-bit
    codebook (``"nf4"`` or ``"fp4"``), ``block_size`` the absmax group.
    ``skip_modules`` and ``keep_in_fp32_modules`` keep a weight dense when one
    of them is a substring of its dotted parameter name; weights with fewer
    than ``min_weight_size`` elements stay dense. ``compute_dtype`` is the
    dtype `dequantize` returns by default."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    quant_type: str = "nf4"
    block_size: int = 64
    compute_dtype: torch.dtype = torch.bfloat16
    skip_modules: list = field(default_factory=list)
    keep_in_fp32_modules: list = field(default_factory=list)
    min_weight_size: int = 4096

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("Pick one of load_in_8bit / load_in_4bit, not both")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("One of load_in_8bit / load_in_4bit must be set")
        if self.quant_type not in ("nf4", "fp4"):
            raise ValueError(f"quant_type must be nf4 or fp4, got {self.quant_type}")

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4


class QuantizedTensor:
    """A quantized weight: ``data`` (int8 values, or uint8 bytes holding two
    4-bit codes) and ``scales`` (one fp32 absmax per block), with the dense
    ``shape``, ``bits``, ``quant_type`` and ``compute_dtype`` beside them.
    ``_plane_pack`` caches the nf4 kernel's layout (`ops.nf4_matmul.plane_pack`)."""

    __slots__ = ("data", "scales", "shape", "bits", "quant_type", "compute_dtype", "_plane_pack")

    def __init__(self, data: torch.Tensor, scales: torch.Tensor, shape, bits: int,
                 quant_type: str, compute_dtype: torch.dtype):
        self.data = data
        self.scales = scales
        self.shape = tuple(int(d) for d in shape)
        self.bits = int(bits)
        self.quant_type = quant_type
        self.compute_dtype = compute_dtype
        self._plane_pack = None

    @property
    def nbytes(self) -> int:
        """Payload and scale bytes (the plane-pack cache is not counted)."""
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        kind = "int8" if self.bits == 8 else self.quant_type
        return f"QuantizedTensor({kind}, shape={self.shape}, blocks={self.scales.shape[0]})"


def from_numpy(data: np.ndarray, scales: np.ndarray, shape, bits: int, quant_type: str,
               compute_dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu") -> QuantizedTensor:
    """A `QuantizedTensor` from a reference ``QuantizedTensor``'s fields as
    numpy arrays (``data``, ``scales``, ``shape``, ``bits``, ``quant_type``):
    carries packed weights across packages, byte for byte."""
    return QuantizedTensor(torch.from_numpy(np.array(data)).to(device),
                           torch.from_numpy(np.asarray(scales, np.float32).copy()).to(device),
                           shape, bits, quant_type, compute_dtype)


@torch.no_grad()
def _quantize_blocks(tensor: torch.Tensor, block: int, kind: str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blockwise pass, on the tensor's own device, as the reference's
    host path does it: zero-pad the flattened tensor to whole blocks, take
    each block's absmax (1.0 for an all-zero block), then int8 ``clip(round(x
    / absmax * 127))`` or the nearest 4-bit code by binary search over the
    sorted codebook's midpoints (``bucketize(right=False)`` is numpy's
    ``searchsorted(side="left")``). Returns ``(payload, fp32 scales)``."""
    flat = tensor.detach().reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    scales = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    normed = blocks / scales[:, None]
    del flat, blocks, absmax
    if kind == "int8":
        return torch.clamp(torch.round(normed * 127.0), -127, 127).to(torch.int8).reshape(-1), scales
    mids, order = _search_tables(kind)
    pos = torch.bucketize(normed.reshape(-1), torch.from_numpy(mids).to(normed.device), right=False)
    del normed
    idx = torch.from_numpy(order).to(pos.device)[pos]
    return (idx[0::2] << 4) | idx[1::2], scales  # two nibbles per byte


def _quantize_leaf_device(a: torch.Tensor, block: int, kind: str,
                          device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-quantize ONE leaf on ``device`` (the reference's
    ``_quantize_leaf_device``): the leaf is copied there, quantized in one
    pass, and its copy freed when the pass returns, so a quantized load
    holds the packed payload plus one leaf (and the pass's temporaries) on
    the card. The nearest-code search is the host path's, as in
    `_quantize_blocks`: the payload and scales are the reference's (its
    device pass takes the nearest code by a distance argmin, which can pick
    the other code only on a tie at a midpoint in fp32)."""
    return _quantize_blocks(to_device(a, device), block, kind)


def quantize(tensor: torch.Tensor, config: QuantizationConfig, on_device: bool = False,
             device: str | torch.device | None = None) -> QuantizedTensor:
    """Blockwise-quantize one tensor (see `_quantize_blocks`), where it
    lives, or with ``on_device=True`` on ``device`` (None: CUDA), where the
    result then lives."""
    kind = "int8" if config.bits == 8 else config.quant_type
    if on_device:
        payload, scales = _quantize_leaf_device(tensor, int(config.block_size), kind,
                                                resolve_device(device))
    else:
        payload, scales = _quantize_blocks(tensor, int(config.block_size), kind)
    return QuantizedTensor(payload, scales, tuple(tensor.shape), config.bits, config.quant_type,
                           config.compute_dtype)


@functools.lru_cache(maxsize=None)
def _byte_values(quant_type: str, device: torch.device) -> torch.Tensor:
    """``[256, 2]`` fp32: the codebook values of a packed byte's high and
    low nibble, so a payload dequantizes in one gather. Built once per
    codebook and device: its copy from host memory could not run inside a
    CUDA graph capture (the serving engine's decode step dequantizes a
    quantized tied head and embedding there)."""
    code = torch.from_numpy(_codebook(quant_type)).to(device)
    byte = torch.arange(256, device=device)
    return torch.stack([code[byte >> 4], code[byte & 0xF]], dim=-1)


def dequantize(qt: QuantizedTensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The dense tensor, in ``dtype`` (default: ``qt.compute_dtype``):
    int8 values / 127 or codebook values, times the block's fp32 scale."""
    out_dtype = qt.compute_dtype if dtype is None else dtype
    n_blocks = qt.scales.shape[0]
    if qt.bits == 8:
        vals = qt.data.float().reshape(n_blocks, -1) / 127.0
    else:
        vals = _byte_values(qt.quant_type, qt.data.device)[qt.data.long()].reshape(n_blocks, -1)
    dense = (vals * qt.scales[:, None]).reshape(-1)
    size = int(np.prod(qt.shape)) if qt.shape else 1
    return dense[:size].reshape(qt.shape).to(out_dtype)


def dequantize_rows(qt: QuantizedTensor, rows: torch.Tensor,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """``dequantize(qt)[rows]`` for a 2-D table (an embedding lookup). When a
    row is a whole number of blocks, only the rows' blocks are read and
    dequantized, with the same values; otherwise the whole table is."""
    num, dim = qt.shape
    block = -(-num * dim // qt.scales.shape[0])
    if dim % block:
        return dequantize(qt, dtype)[rows]
    out_dtype = qt.compute_dtype if dtype is None else dtype
    idx = rows.reshape(-1).long()
    per_row = dim * qt.bits // 8
    data = qt.data.reshape(num, per_row)[idx].reshape(-1)
    scales = qt.scales.reshape(num, dim // block)[idx].reshape(-1)
    part = QuantizedTensor(data, scales, (idx.numel(), dim), qt.bits, qt.quant_type, out_dtype)
    return dequantize(part).reshape(*rows.shape, dim)


def _eligible(name: str, tensor: torch.Tensor, config: QuantizationConfig) -> bool:
    """The reference's rule: floating, ndim >= 2, at least ``min_weight_size``
    elements, and no skip entry a substring of the name."""
    skip = list(config.skip_modules) + list(config.keep_in_fp32_modules)
    return (tensor.ndim >= 2 and tensor.is_floating_point()
            and tensor.numel() >= config.min_weight_size
            and not any(s in name for s in skip))


def quantize_params(params: dict[str, Any], config: QuantizationConfig, on_device: bool = False,
                    device: str | torch.device | None = None) -> dict[str, Any]:
    """A new ``{name: leaf}`` dict with every eligible tensor quantized (see
    `QuantizationConfig`); other leaves, and leaves already quantized, pass
    through. Each tensor is quantized in the layout given: pass a
    projection as ``weight.T`` to get the reference's bytes.
    ``on_device=True`` quantizes each eligible leaf on ``device`` (None:
    CUDA), one at a time (`_quantize_leaf_device`): a host leaf goes to the
    card, is quantized there, and its dense copy is freed before the next."""
    return {name: (quantize(leaf, config, on_device, device) if isinstance(leaf, torch.Tensor)
                   and _eligible(name, leaf, config) else leaf)
            for name, leaf in params.items()}


def dequantize_params(params: dict[str, Any], dtype: torch.dtype | None = None) -> dict[str, Any]:
    """Inverse of `quantize_params`: quantized leaves back to dense tensors."""
    return {name: dequantize(leaf, dtype) if isinstance(leaf, QuantizedTensor) else leaf
            for name, leaf in params.items()}


class QuantizedLinear(nn.Module):
    """An ``nn.Linear`` whose weight is a `QuantizedTensor` in the
    reference's ``[in_features, out_features]`` layout; the bias stays the
    dense module's (shared)."""

    def __init__(self, qweight: QuantizedTensor, bias: nn.Parameter | None):
        super().__init__()
        self.qweight = qweight
        self.in_features, self.out_features = qweight.shape
        self.bias = bias


class QuantizedEmbedding(nn.Module):
    """An ``nn.Embedding`` whose ``[num_embeddings, embedding_dim]`` table
    is a `QuantizedTensor`. ``bare`` marks one that stands for a bare table
    parameter of its parent (a ``quantizable_tables`` entry) rather than for
    an ``nn.Embedding``: its leaf name is the parameter's own, without
    ``.weight``."""

    def __init__(self, qweight: QuantizedTensor, bare: bool = False):
        super().__init__()
        self.qweight = qweight
        self.bare = bare
        self.num_embeddings, self.embedding_dim = qweight.shape


def named_leaves(module: nn.Module) -> Iterator[tuple[str, Any]]:
    """Every weight leaf of a (possibly quantized) module by dotted name, in
    the reference's layout: a quantized leaf as its `QuantizedTensor`
    (``<layer>.weight``), a dense ``nn.Linear`` weight transposed to ``[in,
    out]``, every other parameter as it is."""
    for prefix, mod in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(mod, (QuantizedLinear, QuantizedEmbedding)):
            yield prefix if getattr(mod, "bare", False) else dot + "weight", mod.qweight
        for pname, p in mod.named_parameters(recurse=False):
            yield dot + pname, p.T if isinstance(mod, nn.Linear) and pname == "weight" else p


def _swap(module: nn.Module, config: QuantizationConfig, name: str,
          load: Any = None, device: torch.device | None = None) -> nn.Module:
    """The layer swap of `quantize_module` (``load`` None: the module's own
    weights, quantized where they live) and `load_and_quantize_model`
    (``load(name)``: the named checkpoint tensor in host memory; each
    eligible one is quantized on ``device`` by `quantize(on_device=True)`,
    every other one copied there)."""

    def quantized(pname: str, p: torch.Tensor, transpose: bool = False) -> QuantizedTensor:
        t = p.detach() if load is None else load(pname)
        return quantize(t.T if transpose else t, config, on_device=load is not None,
                        device=device)

    def keep(pname: str, p: nn.Parameter) -> nn.Parameter:  # a dense leaf of the result
        if load is None:
            return p
        return nn.Parameter(to_device(load(pname), device).to(p.dtype), requires_grad=False)

    weight = getattr(module, "weight", None)
    if isinstance(module, nn.Linear) and _eligible(f"{name}weight", weight, config):
        bias = None if module.bias is None else keep(f"{name}bias", module.bias)
        return QuantizedLinear(quantized(f"{name}weight", weight, transpose=True), bias)
    if isinstance(module, nn.Embedding) and _eligible(f"{name}weight", weight, config):
        return QuantizedEmbedding(quantized(f"{name}weight", weight))
    dense_kind = isinstance(module, (nn.Linear, nn.Embedding))
    tables = getattr(module, "quantizable_tables", ())
    out = copy.copy(module)
    out._parameters, out._modules = {}, {}
    for pname, p in module._parameters.items():
        if p is not None and not dense_kind and _eligible(name + pname, p, config):
            if pname not in tables:
                raise TypeError(f"cannot quantize {name}{pname} of a {type(module).__name__}")
            out._modules[pname] = QuantizedEmbedding(quantized(name + pname, p), bare=True)
        else:
            out._parameters[pname] = None if p is None else keep(name + pname, p)
    for cname, child in module._modules.items():
        out._modules[cname] = None if child is None else _swap(child, config, f"{name}{cname}.",
                                                               load, device)
    return out


def quantize_module(module: nn.Module, config: QuantizationConfig) -> nn.Module:
    """A quantized copy of ``module`` (the reference's ``quantize_params``
    over a model): every ``nn.Linear`` and ``nn.Embedding`` whose weight
    passes the eligibility rule (named ``<layer>.weight``, a projection
    quantized as ``weight.T``) becomes a `QuantizedLinear` or
    `QuantizedEmbedding`, quantized on the weight's device, and so does every
    eligible bare table a module lists in ``quantizable_tables``. Every other
    module is copied shallowly, so dense parameters are shared and ``module``
    itself is left as it was. Raises TypeError for any other eligible
    parameter. A `PreparedModel` stands for its module."""
    return _swap(_unwrap(module), config, "")


def _unwrap(model: Any) -> Any:
    """The module behind what `Accelerator.prepare` returned."""
    from ..accelerator import PreparedModel

    return model.module if isinstance(model, PreparedModel) else model


def quantize_model(model: nn.Module, config: QuantizationConfig) -> nn.Module:
    """Quantize a prepared model's weights in place (the reference's
    ``quantize_model``, whose layer-swap role this takes literally): the
    swap of `quantize_module`, written into ``model`` itself, which is
    returned. ``Accelerator.prepare`` returns a `PreparedModel` over the
    model, so this takes what it returns and quantizes its module. The dense
    weights that were swapped out are freed once nothing else holds them."""
    model = _unwrap(model)
    if not isinstance(model, nn.Module):
        raise TypeError(f"Cannot quantize object of type {type(model)}")
    swapped = quantize_module(model, config)
    model._parameters, model._modules = swapped._parameters, swapped._modules
    return model


def load_and_quantize_model(model: nn.Module, weights_location: str | os.PathLike,
                            quantization_config: QuantizationConfig,
                            mapper: Any = None,
                            device: str | torch.device | None = None) -> nn.Module:
    """Fill ``model`` from a safetensors checkpoint and quantize it (the
    reference's ``load_and_quantize_model``), in place; returns ``model``.

    ``model`` gives the structure: build it on ``device="meta"`` so no dense
    weight is allocated. The checkpoint is read to host memory (``mapper``
    turns its names and layout into the model's state dict, as in
    `safetensors_io.load_checkpoint_in_model`); then, leaf by leaf, each
    eligible weight goes to ``device`` (None: CUDA), is quantized there and
    its dense copy freed (`quantize(on_device=True)`, i.e.
    `_quantize_leaf_device`, the pass `quantize_params(on_device=True)`
    makes), and every other leaf goes there in the parameter's dtype. The
    card holds the packed payload and one leaf at a time."""
    dev = resolve_device(device)
    flat = load_safetensors_checkpoint(weights_location)
    state = mapper(flat) if mapper is not None else flat
    del flat
    unused = set(state)

    def load(name: str) -> torch.Tensor:
        if name not in state:
            raise KeyError(f"{name} is not in the checkpoint at {weights_location}")
        unused.discard(name)
        return state[name]

    swapped = _swap(model, quantization_config, "", load, dev)
    if unused:
        raise ValueError(f"checkpoint entries the model has no place for: {sorted(unused)[:8]}")
    model._parameters, model._modules = swapped._parameters, swapped._modules
    return model


def dequantize_module(module: nn.Module, dtype: torch.dtype | None = None) -> nn.Module:
    """A dense copy of a quantized module (the reference's
    ``dequantize_params`` over a model): each `QuantizedLinear` and
    `QuantizedEmbedding` becomes an ``nn.Linear`` or ``nn.Embedding`` (a bare
    one its parent's table parameter again) holding `dequantize` of its
    weight in ``dtype`` (default: the tensor's ``compute_dtype``); other
    parameters are shared."""
    out = copy.copy(module)
    out._modules = dict(module._modules)
    for child_name, child in list(out._modules.items()):
        if isinstance(child, QuantizedLinear):
            w = dequantize(child.qweight, dtype)
            lin = nn.Linear(child.in_features, child.out_features, bias=child.bias is not None,
                            device=w.device, dtype=w.dtype)
            lin.weight = nn.Parameter(w.T.contiguous(), requires_grad=False)
            lin.bias = child.bias
            out._modules[child_name] = lin
        elif isinstance(child, QuantizedEmbedding) and child.bare:
            del out._modules[child_name]
            out._parameters = {**out._parameters, child_name: nn.Parameter(
                dequantize(child.qweight, dtype), requires_grad=False)}
        elif isinstance(child, QuantizedEmbedding):
            w = dequantize(child.qweight, dtype)
            emb = nn.Embedding(*w.shape, device=w.device, dtype=w.dtype)
            emb.weight = nn.Parameter(w, requires_grad=False)
            out._modules[child_name] = emb
        elif child is not None:
            out._modules[child_name] = dequantize_module(child, dtype)
    return out


def quantized_nbytes(params: dict[str, Any] | nn.Module) -> int:
    """Resident bytes of a (possibly partially) quantized dict of leaves or
    module: payload and scales of each quantized leaf, ``nbytes`` of each
    dense one. A module's shared parameters count once."""
    leaves = named_leaves(params) if isinstance(params, nn.Module) else params.items()
    seen, total = set(), 0
    for _, leaf in leaves:
        key = id(leaf.data) if isinstance(leaf, QuantizedTensor) else leaf.data_ptr()
        if key in seen:
            continue
        seen.add(key)
        total += (leaf.nbytes if isinstance(leaf, QuantizedTensor)
                  else leaf.numel() * leaf.element_size())
    return total
