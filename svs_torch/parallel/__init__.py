"""Data-parallel, sharded, tensor-parallel and pipeline-parallel training
and segment-parallel decode (port of ``svs_tpu/parallel/``, the mesh, DP,
ZeRO-1, FSDP, TP and PP layouts): :mod:`mesh` (the process group and its
2-D view, the batch distributors, the batch-crossing sum, the gathers),
:mod:`dp` (the DP train and eval steps, the segment-parallel decode),
:mod:`zero` (the channel sharding rule, the ZeRO-1 and FSDP states and
step), :mod:`tp` (the channel-partitioned forward and the TP steps),
:mod:`pp` (the two-stage split of the U-Net, its state and its pipelined
steps, one process over two stage devices), :mod:`launch` (a pool of
local ranks) and :mod:`dryrun` (``bench_cli --dp-smoke``)."""
