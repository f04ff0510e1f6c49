"""Rematerialization policies: the port of `accelerate_tpu.utils.remat`.

A block wrapped by `remat_block` runs under non-reentrant
``torch.utils.checkpoint``: its forward keeps only what the policy saves,
and the backward runs the block again for the rest. The named policies are
the reference's:

- ``"full"`` (``"nothing"`` an alias): save nothing, recompute everything;
- ``"dots"``: save the outputs of the matrix products (``aten.mm``,
  ``addmm``, ``bmm`` and the fp8 ``_scaled_mm``), recompute the rest,
  through selective checkpointing (``create_selective_checkpoint_contexts``);
- ``"dots_no_batch"``: as ``"dots"`` without ``bmm``: batched products
  (attention scores on the plain path) recompute too.

A policy may also be a callable ``(ctx, op, *args, **kwargs) ->
CheckpointPolicy``, as selective checkpointing takes it.

Three things the recompute must not do differently from the first
forward, and how `remat_block` keeps them equal:

- the weights: the train step runs the model under
  `torch.func.functional_call` on compute-dtype copies of the masters, and
  the recompute runs in the backward, after that call has put the
  module's own tensors back. `remat_block` takes the tensors a module block
  holds when it is called and runs both the forward and the recompute on
  them (a bf16 LayerNorm scale would otherwise be recomputed from its fp32
  master);
- fp8 scaling state (`ops.fp8.Fp8Linear`): the first forward advances each
  layer's delayed-scaling state once. The recompute runs inside a `Frame`
  whose ``recompute`` flag is set; the layers then read the scales the first
  forward used (``Frame.saved``) and leave the state alone.
- dropout drawn from an explicit ``torch.Generator``: checkpoint's
  ``preserve_rng_state`` restores only the global generators. The block's
  generator state is taken before the first forward, and the recompute draws
  from a fresh generator at that state, so it makes the same masks and the
  caller's generator advances once.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch.func import functional_call
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten._scaled_mm.default)
_SAVED_OPS: dict[str, tuple | None] = {
    "full": None,
    "nothing": None,
    "dots": _DOTS + (_aten.bmm.default,),
    "dots_no_batch": _DOTS,
}


def _save_ops(ops: tuple, ctx: Any, op: Any, *args: Any, **kwargs: Any) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: str | Callable | None) -> Callable | None:
    """A policy name as a selective-checkpoint policy callable, None for
    "save nothing" (``None``, ``"full"``, ``"nothing"``); a callable passes
    through. Any other name raises the reference's ValueError."""
    if name is None or callable(name):
        return name
    try:
        ops = _SAVED_OPS[name]
    except KeyError:
        raise ValueError(
            f"Unknown remat policy {name!r}; choose from {sorted(_SAVED_OPS)} "
            "or pass a selective-checkpoint policy callable."
        ) from None
    return None if ops is None else functools.partial(_save_ops, ops)


class Frame:
    """One checkpointed call of a block: ``recompute`` is False in its first
    forward and True when the backward runs it again; ``saved`` holds what
    layers of the block keep from the first forward for the recompute (the
    fp8 scales, by layer)."""

    __slots__ = ("recompute", "saved", "calls")

    def __init__(self):
        self.recompute = False
        self.saved: dict[int, Any] = {}
        self.calls = 0


_FRAME: contextvars.ContextVar[Frame | None] = contextvars.ContextVar(
    "accelerate_tpu_torch_remat_frame", default=None)


def current_frame() -> Frame | None:
    """The `Frame` of the checkpointed block running now, None outside one."""
    return _FRAME.get()


def remat_block(block: Callable, policy_name: str | Callable | None = None) -> Callable:
    """``block`` (a module or function) under non-reentrant checkpoint with
    the named policy: call the result as the block, with the dropout
    generator, if any, as the keyword ``generator``."""
    policy = resolve_remat_policy(policy_name)

    def call(*args: Any, generator: torch.Generator | None = None, **kwargs: Any) -> Any:
        frame = Frame()
        gen_state = None if generator is None else generator.get_state()
        held = None
        if isinstance(block, torch.nn.Module):
            held = {**dict(block.named_parameters(remove_duplicate=False)),
                    **dict(block.named_buffers(remove_duplicate=False))}

        def target(*a: Any, **kw: Any) -> Any:
            return block(*a, **kw) if held is None else functional_call(block, held, a, kw)

        def run(*inner: Any) -> Any:
            frame.recompute = frame.calls > 0
            frame.calls += 1
            gen = generator
            if frame.recompute and generator is not None:
                gen = torch.Generator(device=generator.device)
                gen.set_state(gen_state)
            token = _FRAME.set(frame)
            try:
                if generator is None:
                    return target(*inner, **kwargs)
                return target(*inner, generator=gen, **kwargs)
            finally:
                _FRAME.reset(token)

        extra = {}
        if policy is not None:
            extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy)
        # the port's random draws go through explicit generators, replayed
        # above: the global generators need no stash
        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                                 preserve_rng_state=False, **extra)

    return call
