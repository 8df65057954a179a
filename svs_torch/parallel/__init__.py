"""Data-parallel and sharded training and segment-parallel decode over
``torch.distributed`` (port of ``svs_tpu/parallel/``, the mesh, DP, ZeRO-1
and FSDP layouts): :mod:`mesh` (the process group, the batch
distributors, the batch-crossing sum, the gathers), :mod:`dp` (the DP
train and eval steps, the segment-parallel decode), :mod:`zero` (the
channel sharding rule, the ZeRO-1 and FSDP states and step), :mod:`launch`
(a pool of local ranks) and :mod:`dryrun` (``bench_cli --dp-smoke``)."""
