"""Parallelism over processes: the port of `accelerate_tpu.parallel`.

`mesh` names the ranks' axes (`ParallelismConfig`, `build_mesh`) and
`compression` reduces gradients over the ``data`` axis, plainly or through
the reference's comm hooks. Only the ``data`` axis is ported: the ``fsdp``,
``tensor``, ``sequence`` and ``stage`` axes (sharding, ring attention,
Ulysses, pipelines) wait for ROADMAP Queue 1, item 21.3.
"""
