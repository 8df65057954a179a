"""``train`` CLI (port of ``svs_tpu/cli/train_cli.py``).

Flag surface preserved from reference train.py:157-167:
  --train_folder --load_path --label(required) --epoch --batch_size
  --valid_folder --val_interval
and svs_tpu's extensions (--preset --seed --export_pth --ckpt_dir --log_dir
--samples_per_song --dtype --remat --save_every --async_save --device_data
--device_data_cap_mb --accum --augment --remix_p --aug_gain --epoch_scan
--val_sdr --val_sdr_songs --dp --zero1 --fsdp), plus --device (default
cuda; ``--device cpu`` runs on the host).  ``--epoch_scan`` replays a
captured CUDA graph of the step for each epoch's full batches (it needs
the dataset on the device).  ``--dp`` trains data-parallel over the ranks
of ``torchrun`` (``torchrun --nproc_per_node N -m svs_torch.cli.train_cli
--dp ...``: NCCL on the cards, gloo with ``--device cpu``), or alone at
world size 1 (``parallel.mesh.make_mesh``); with it ``--zero1`` shards
Adam's moments over the ranks and ``--fsdp`` the parameters and BN
statistics too (``parallel.zero``); either needs ``--dp``, as svs_tpu's
does, and neither goes with ``--epoch_scan``.  The other parallel and
multi-host flags (--multihost --coordinator --num_hosts --host_id --cp
--tp --pp, and --epoch_scan with --dp) exit 2 with a message that names
their ROADMAP item.

Run as ``python -m svs_torch.cli.train_cli``.
"""

from __future__ import annotations

import argparse
import dataclasses

# flag -> the ROADMAP item that ports it
UNPORTED = {
    "multihost": "A.10.7", "coordinator": "A.10.7", "num_hosts": "A.10.7",
    "host_id": "A.10.7", "cp": "A.10.6", "tp": "A.10.4", "pp": "A.10.5",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the SVS U-Net (cuda by default; --dp over the "
                    "ranks of torchrun).")
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
                   help="not ported (ROADMAP A.10.7)")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT", help="not ported (ROADMAP A.10.7)")
    p.add_argument("--num_hosts", type=int, default=None,
                   help="not ported (ROADMAP A.10.7)")
    p.add_argument("--host_id", type=int, default=None,
                   help="not ported (ROADMAP A.10.7)")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the ranks of torchrun (world "
                        "size 1 without it): sync-BN, the gradient summed "
                        "over the ranks, rank 0 writes")
    p.add_argument("--cp", action="store_true",
                   help="not ported (ROADMAP A.10.6)")
    p.add_argument("--tp", type=int, default=None, metavar="K",
                   help="not ported (ROADMAP A.10.4)")
    p.add_argument("--pp", action="store_true",
                   help="not ported (ROADMAP A.10.5)")
    p.add_argument("--pp_micro", type=int, default=4, metavar="N",
                   help="with --pp (not ported)")
    p.add_argument("--pp_split", type=int, default=3, metavar="K",
                   help="with --pp (not ported)")
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
    # svs_tpu's rules for the sharded layouts (svs_tpu train_cli.py:196-201)
    if (args.zero1 or args.fsdp) and not args.dp:
        parser.error("--zero1/--fsdp shard training state across a DP "
                     "mesh; pass --dp with them")
    if (args.zero1 or args.fsdp) and args.tp is not None:
        parser.error("--zero1/--fsdp compose with --dp only (TP already "
                     "shards the state with its channels)")
    if (args.zero1 or args.fsdp) and args.epoch_scan:
        from svs_torch.train.loop import SCAN_REFUSAL
        parser.error(f"--epoch_scan with --zero1/--fsdp: {SCAN_REFUSAL}")
    for flag, item in UNPORTED.items():
        value = getattr(args, flag)
        if value not in (None, False):
            parser.error(f"--{flag} is not ported to svs_torch yet "
                         f"(ROADMAP {item})")
    if args.dp and args.epoch_scan:
        parser.error("--epoch_scan with --dp (a captured step over a mesh) "
                     "is not ported to svs_torch yet (ROADMAP A.10.2)")
    if args.accum < 1:
        parser.error(f"--accum must be a positive microbatch count, "
                     f"got {args.accum}")

    from svs_torch.train.loop import TrainOptions, fit
    from svs_torch.utils.config import get_config

    mesh = None
    if args.dp:
        from svs_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device=args.device)

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
        zero1=args.zero1,
        fsdp=args.fsdp,
        device=args.device,
    )
    fit(opts, cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
