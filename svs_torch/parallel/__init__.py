"""Data-parallel, sharded, tensor-parallel, pipeline-parallel and
context-parallel training and segment-parallel and whole-song decode (port
of ``svs_tpu/parallel/``, the mesh, DP, ZeRO-1, FSDP, TP, PP and CP
layouts): :mod:`mesh` (the process group and its 2-D view, the batch
distributors, the batch-crossing sum, the gathers, the halo exchange),
:mod:`dp` (the DP train and eval steps, the segment-parallel decode),
:mod:`zero` (the channel sharding rule, the ZeRO-1 and FSDP states and
step), :mod:`tp` (the channel-partitioned forward and the TP steps),
:mod:`pp` (the two-stage split of the U-Net, its state and its pipelined
steps, one process over two stage devices), :mod:`halo` (the time-sharded
forward, the CP step and the whole-song decode), :mod:`launch` (a pool of
local ranks) and :mod:`dryrun` (``bench_cli --dp-smoke``)."""
