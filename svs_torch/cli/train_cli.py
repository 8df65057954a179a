"""``train`` CLI (port of ``svs_tpu/cli/train_cli.py``).

Flag surface preserved from reference train.py:157-167:
  --train_folder --load_path --label(required) --epoch --batch_size
  --valid_folder --val_interval
and svs_tpu's extensions (--preset --seed --export_pth --ckpt_dir --log_dir
--samples_per_song --dtype --remat --save_every --async_save --device_data
--device_data_cap_mb --accum --augment --remix_p --aug_gain --epoch_scan
--val_sdr --val_sdr_songs --multihost --coordinator --num_hosts --host_id
--dp --zero1 --fsdp --cp --tp --pp --pp_micro --pp_split), plus --device
(default
cuda; ``--device cpu`` runs on the host).  ``--epoch_scan`` replays a
captured CUDA graph of the step for each epoch's full batches (it needs
the dataset on the device).  ``--dp`` trains data-parallel over the ranks
of ``torchrun`` (``torchrun --nproc_per_node N -m svs_torch.cli.train_cli
--dp ...``: NCCL on the cards, gloo with ``--device cpu``), or alone at
world size 1 (``parallel.mesh.make_mesh``); with it ``--zero1`` shards
Adam's moments over the ranks and ``--fsdp`` the parameters and BN
statistics too (``parallel.zero``); either needs ``--dp``, as svs_tpu's
does, and neither goes with ``--epoch_scan``.  ``--cp`` trains
context-parallel (``parallel.halo``): each patch's time axis cut over the
ranks of ``torchrun`` (``torchrun --nproc_per_node N -m
svs_torch.cli.train_cli --cp ...``; the preset's ``input_len`` a multiple
of 64 N), or alone at world size 1; it goes with none of --dp --tp --pp
--epoch_scan.  ``--tp K`` trains
tensor-parallel (``parallel.tp``): the conv channels cut K ways over a
(n_data, K) mesh of torchrun's ranks (``torchrun --nproc_per_node N -m
svs_torch.cli.train_cli --tp K [--dp] ...``), n_data = N / K with
``--dp``, else 1 (then N must be K); it goes with none of --cp --pp
--zero1 --fsdp --epoch_scan.  ``--pp`` trains pipeline-parallel
(``parallel.pp``) in one process over two stage devices: ``cuda:0`` and
``cuda:1`` (with one card it exits 2 with ``make_pp_mesh``'s message), or
both stages on the host with ``--device cpu``; ``--pp_micro`` microbatches
a step (default 4, must divide --batch_size), the U split at encoder
depth ``--pp_split`` (default 3); it goes with none of --dp --cp --tp
--zero1 --fsdp --accum --epoch_scan.  ``--multihost`` trains over several
hosts (``parallel.multihost``; with --dp, --dp --zero1/--fsdp, --tp or
--cp): under ``torchrun --nnodes N`` a host is a node, read from its
environment; ``--coordinator HOST:PORT --num_hosts N --host_id I`` (which
implies ``--multihost``) makes this process host I of N, one rank a host,
without torchrun; the multi-host run refuses --epoch_scan, as svs_tpu's
``fit`` does.  ``--epoch_scan`` with ``--dp`` replays a captured graph of
the DP step, its collectives included, on every rank (``torchrun
--nproc_per_node N -m svs_torch.cli.train_cli --dp --epoch_scan ...``;
eager gloo ranks with ``--device cpu``).

Run as ``python -m svs_torch.cli.train_cli``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

def tp_mesh_shape(world: int, k: int, dp: bool) -> int:
    """The data axis of ``--tp k`` over ``world`` ranks (svs_tpu
    train_cli.py:203-216): ``world // k`` with ``--dp``, else 1; every
    rank is on the mesh."""
    if world % k:
        raise ValueError(f"--tp {k} does not divide the {world} ranks")
    n_data = world // k if dp else 1
    if n_data * k != world:
        raise ValueError(f"--tp {k} without --dp is a (1, {k}) mesh of {k} "
                         f"ranks, not {world}: pass --dp for a "
                         f"({world // k}, {k}) mesh")
    return n_data


# torchrun's per-node environment, which --multihost reads the hosts from
TORCHRUN_HOSTS = ("RANK", "WORLD_SIZE", "GROUP_RANK", "LOCAL_WORLD_SIZE")


def _multihost_env(parser: argparse.ArgumentParser, args) -> None:
    """svs_tpu's multi-host rules (train_cli.py:156-175) on torchrun's
    environment: under torchrun the hosts are its nodes; ``--coordinator``
    without it makes this process host ``--host_id`` of ``--num_hosts``,
    one rank a host, by setting that environment before the mesh joins
    the group."""
    if args.coordinator is not None:
        if args.num_hosts is None or args.host_id is None:
            parser.error("--coordinator requires --num_hosts and --host_id")
        if "RANK" in os.environ or "WORLD_SIZE" in os.environ:
            parser.error("--coordinator makes one rank a host without "
                         "torchrun; under torchrun the hosts come from its "
                         "environment: pass --multihost alone")
        addr, _, port = args.coordinator.rpartition(":")
        if not addr or not port.isdigit():
            parser.error(f"--coordinator wants HOST:PORT, got "
                         f"{args.coordinator!r}")
        if not 0 <= args.host_id < args.num_hosts:
            parser.error(f"--host_id {args.host_id} is not one of "
                         f"{args.num_hosts} hosts")
        os.environ.update(
            MASTER_ADDR=addr, MASTER_PORT=port, RANK=str(args.host_id),
            WORLD_SIZE=str(args.num_hosts), LOCAL_WORLD_SIZE="1",
            GROUP_RANK=str(args.host_id), LOCAL_RANK="0")
    elif args.num_hosts is not None or args.host_id is not None:
        # else dropped where the hosts come from torchrun
        parser.error("--num_hosts/--host_id require --coordinator (without "
                     "one, the hosts come from torchrun's environment)")
    elif not all(k in os.environ for k in TORCHRUN_HOSTS):
        parser.error("--multihost takes the hosts from torchrun's "
                     "environment (" + ", ".join(TORCHRUN_HOSTS) + "): run "
                     "under torchrun --nnodes N, or pass --coordinator "
                     "HOST:PORT --num_hosts N --host_id I")
    if not (args.dp or args.cp or args.tp is not None):
        parser.error("multi-host training needs a mesh: pass --dp, --cp or "
                     "--tp with it")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the SVS U-Net (cuda by default; --dp / --cp / "
                    "--tp over the ranks of torchrun, --pp over two stage "
                    "devices in one process).")
    p.add_argument("--train_folder", type=str, default="./data/vocals")
    p.add_argument("--load_path", type=str, default="result.ckpt")
    p.add_argument("--label", type=str, required=True)
    p.add_argument("--epoch", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--valid_folder", type=str,
                   default="unet_spectrograms/valid")
    p.add_argument("--val_interval", type=int, default=20)
    # extensions
    p.add_argument("--preset", type=str, default="default",
                   help="config preset (see svs_torch.utils.config.PRESETS)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export_pth", action="store_true",
                   help="also write reference-loadable .pth checkpoints")
    p.add_argument("--multihost", action="store_true",
                   help="train over several hosts (parallel/multihost.py): "
                        "under torchrun --nnodes N a host is a node, read "
                        "from its environment; elsewhere pass --coordinator"
                        "/--num_hosts/--host_id.  Composes with --dp, --dp "
                        "--zero1/--fsdp, --tp and --cp")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="host 0's address for the process group, one rank "
                        "a host without torchrun (implies --multihost; "
                        "requires --num_hosts and --host_id)")
    p.add_argument("--num_hosts", type=int, default=None)
    p.add_argument("--host_id", type=int, default=None)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the ranks of torchrun (world "
                        "size 1 without it): sync-BN, the gradient summed "
                        "over the ranks, rank 0 writes")
    p.add_argument("--cp", action="store_true",
                   help="context-parallel over the ranks of torchrun (world "
                        "size 1 without it): each patch's time axis cut "
                        "over the ranks with halo exchange (parallel/"
                        "halo.py; input_len a multiple of 64 x ranks)")
    p.add_argument("--tp", type=int, default=None, metavar="K",
                   help="tensor-parallel training: conv channels cut K-way "
                        "over the mesh's 'model' axis (parallel/tp.py). "
                        "Alone: a (1, K) mesh of K ranks; with --dp: a "
                        "(ranks // K, K) data x model mesh"),
    p.add_argument("--pp", action="store_true",
                   help="pipeline-parallel training: the U-Net's two "
                        "halves on 2 stage devices (cuda:0 and cuda:1; the "
                        "host with --device cpu), microbatches through a "
                        "two-stage schedule in one process (parallel/pp.py;"
                        " GPipe BN semantics at --pp_micro > 1)")
    p.add_argument("--pp_micro", type=int, default=4, metavar="N",
                   help="with --pp: microbatches per step (must divide "
                        "batch_size; 1 == the single-device step)")
    p.add_argument("--pp_split", type=int, default=3, metavar="K",
                   help="with --pp: encoder depth where the U splits "
                        "across the two stages (1..5)")
    p.add_argument("--zero1", action="store_true",
                   help="with --dp: shard Adam's moments over the ranks "
                        "(ZeRO-1)")
    p.add_argument("--fsdp", action="store_true",
                   help="with --dp: shard the parameters, BN statistics and "
                        "Adam's moments over the ranks (FSDP)")
    p.add_argument("--accum", type=int, default=1, metavar="K",
                   help="gradient accumulation: update params once every "
                        "K microbatches with their mean gradient; resume "
                        "with the same K")
    p.add_argument("--ckpt_dir", type=str, default="CKPT")
    p.add_argument("--log_dir", type=str, default="LOG")
    p.add_argument("--samples_per_song", type=int, default=None,
                   help="override the preset's virtual-epoch patches/song")
    p.add_argument("--dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="conv compute dtype override")
    p.add_argument("--remat", action="store_true",
                   help="recompute U-Net levels in the backward pass "
                        "(less activation memory at long patches, e.g. "
                        "--preset fine_tune)")
    p.add_argument("--save_every", type=int, default=1,
                   help="latest-checkpoint cadence in epochs")
    p.add_argument("--async_save", action="store_true",
                   help="write checkpoints from a worker thread")
    p.add_argument("--device_data", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="keep the spectrogram dataset on the device and "
                        "gather crops there ('auto' gates on "
                        "--device_data_cap_mb)")
    p.add_argument("--device_data_cap_mb", type=float, default=2048.0)
    p.add_argument("--val_sdr", action="store_true",
                   help="also decode the validation songs and log vocal "
                        "SDR/SIR/SAR/NSDR (BSS eval on the device in f64) "
                        "at every validation")
    p.add_argument("--val_sdr_songs", type=int, default=None, metavar="N",
                   help="with --val_sdr: score only the first N songs")
    p.add_argument("--epoch_scan", action="store_true",
                   help="run each epoch's full batches as replays of one "
                        "captured CUDA graph of the step (needs the dataset "
                        "on the device, --device_data on/auto)")
    p.add_argument("--augment", action="store_true",
                   help="remix augmentation: random source gains + "
                        "cross-song vocal remixing, exact via STFT "
                        "linearity (the reference recipe has none)")
    p.add_argument("--remix_p", type=float, default=0.5, metavar="P",
                   help="with --augment: probability a row's vocal is "
                        "swapped for another row's")
    p.add_argument("--aug_gain", type=float, nargs=2, default=(0.25, 1.25),
                   metavar=("LO", "HI"),
                   help="with --augment: per-source gain range U[LO, HI]")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the host)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # svs_tpu's rules for the layouts (svs_tpu train_cli.py:183-201)
    if args.cp and (args.dp or args.tp is not None):
        parser.error("--cp is mutually exclusive with --dp/--tp")
    if args.cp and args.epoch_scan:
        from svs_torch.train.loop import SCAN_REFUSAL
        parser.error(f"--epoch_scan with --cp: {SCAN_REFUSAL}")
    if (args.zero1 or args.fsdp) and not args.dp:
        parser.error("--zero1/--fsdp shard training state across a DP "
                     "mesh; pass --dp with them")
    if (args.zero1 or args.fsdp) and args.tp is not None:
        parser.error("--zero1/--fsdp compose with --dp only (TP already "
                     "shards the state with its channels)")
    if args.tp is not None:
        if args.tp < 1:
            parser.error(f"--tp must be a positive shard count, got "
                         f"{args.tp}")
        if args.cp or args.pp:
            parser.error("--tp is mutually exclusive with --cp/--pp")
        if args.epoch_scan:
            from svs_torch.train.loop import SCAN_REFUSAL
            parser.error(f"--epoch_scan with --tp: {SCAN_REFUSAL}")
    # svs_tpu's rules for --pp (svs_tpu train_cli.py:185-192)
    if args.pp and (args.dp or args.cp or args.tp is not None
                    or args.zero1 or args.fsdp):
        parser.error("--pp is mutually exclusive with the other parallel "
                     "layouts")
    if args.pp and args.accum > 1:
        parser.error("--pp does not compose with --accum (pipeline "
                     "microbatching already accumulates; raise --pp_micro "
                     "instead)")
    if args.pp and args.epoch_scan:
        from svs_torch.train.loop import SCAN_REFUSAL
        parser.error(f"--epoch_scan with --pp: {SCAN_REFUSAL}")
    if (args.zero1 or args.fsdp) and args.epoch_scan:
        from svs_torch.train.loop import SCAN_REFUSAL
        parser.error(f"--epoch_scan with --zero1/--fsdp: {SCAN_REFUSAL}")
    if (args.multihost or args.coordinator is not None
            or args.num_hosts is not None or args.host_id is not None):
        _multihost_env(parser, args)
    if args.accum < 1:
        parser.error(f"--accum must be a positive microbatch count, "
                     f"got {args.accum}")

    from svs_torch.train.loop import TrainOptions, fit
    from svs_torch.utils.config import get_config

    mesh = None
    parallel = "dp"
    if args.tp is not None:
        from svs_torch.parallel.mesh import make_2d_mesh, world_size
        try:
            n_data = tp_mesh_shape(world_size(), args.tp, args.dp)
        except ValueError as e:
            parser.error(str(e))
        mesh = make_2d_mesh(n_data, args.tp, device=args.device)
        parallel = "tp"
        if mesh.is_primary:
            print(f"Tensor-parallel over a ({n_data} data, {args.tp} model) "
                  "mesh")
    elif args.pp:
        import torch

        from svs_torch.parallel.pp import make_pp_mesh
        try:
            mesh = make_pp_mesh(("cpu", "cpu")
                                if torch.device(args.device).type == "cpu"
                                else None)
        except ValueError as e:
            parser.error(str(e))
        parallel = "pp"
        print(f"Pipeline-parallel over 2 stages on {mesh[0]} and {mesh[1]} "
              f"({args.pp_micro} microbatches, split at enc{args.pp_split})")
    elif args.dp or args.cp:
        from svs_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device=args.device)
        if args.cp:
            parallel = "cp"
            if mesh.is_primary:
                print(f"Context(time)-parallel over {mesh.size} devices")
    if mesh is not None and (args.multihost or args.coordinator) \
            and mesh.is_primary:
        print(f"[svs-torch] multi-host: host {mesh.host}/{mesh.hosts}, "
              f"{mesh.local_size} local of {mesh.size} ranks")

    cfg = get_config(args.preset)
    if args.samples_per_song is not None:
        cfg = dataclasses.replace(cfg, samples_per_song=args.samples_per_song)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)

    opts = TrainOptions(
        train_folder=args.train_folder,
        load_path=args.load_path,
        label=args.label,
        epoch=args.epoch,
        batch_size=args.batch_size,
        valid_folder=args.valid_folder,
        val_interval=args.val_interval,
        ckpt_dir=args.ckpt_dir,
        log_dir=args.log_dir,
        seed=args.seed,
        export_pth=args.export_pth,
        save_every=args.save_every,
        async_save=args.async_save,
        device_data=args.device_data,
        device_data_cap_mb=args.device_data_cap_mb,
        accum_steps=args.accum,
        augment=args.augment,
        remix_p=args.remix_p,
        aug_gain_lo=args.aug_gain[0],
        aug_gain_hi=args.aug_gain[1],
        epoch_scan=args.epoch_scan,
        val_sdr=args.val_sdr,
        val_sdr_songs=args.val_sdr_songs,
        mesh=mesh,
        parallel=parallel,
        pp_micro=args.pp_micro,
        pp_split=args.pp_split,
        zero1=args.zero1,
        fsdp=args.fsdp,
        device=args.device,
    )
    fit(opts, cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
