"""Data-parallel training and segment-parallel decode over
``torch.distributed`` (port of ``svs_tpu/parallel/``, the mesh and DP
layouts): :mod:`mesh` (the process group, the batch distributors and the
batch-crossing sum), :mod:`dp` (the DP train and eval steps, the
segment-parallel decode), :mod:`launch` (a pool of local ranks) and
:mod:`dryrun` (``bench_cli --dp-smoke``)."""
