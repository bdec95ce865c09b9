"""The parallel layer: WRMF on a mesh of processes (``torch.distributed``).

Port of the WRMF half of ``rsparse_tpu/parallel/``: :mod:`.mesh` (meshes,
this rank's slices, the collectives), :mod:`.multihost` (bring-up,
per-process bucket building), :mod:`.wrmf_step` (the sharded half-sweep),
:mod:`.routing` and :mod:`.alx` (the routed ALX sweeps) and
:mod:`.topk_sharded` (item-sharded top-k).  The sharded SGD models
(``sgd_sharded.py``) are not ported yet (ROADMAP.md).
"""
