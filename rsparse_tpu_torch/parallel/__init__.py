"""The parallel layer: WRMF and the SGD family on a mesh of processes
(``torch.distributed``).

Port of ``rsparse_tpu/parallel/``: :mod:`.mesh` (meshes, this rank's
slices, the collectives), :mod:`.multihost` (bring-up, per-process bucket
building), :mod:`.wrmf_step` (the sharded half-sweep), :mod:`.routing` and
:mod:`.alx` (the routed ALX sweeps), :mod:`.topk_sharded` (item-sharded
top-k) and :mod:`.sgd_sharded` (FTRL, FM, RankMF and GloVe with their state
tables row-sharded: replicated batch, sharded tables).
"""
