"""``serve`` CLI: the HTTP separation service (port of
``svs_tpu/cli/serve_cli.py``).

svs_tpu's flags, plus --device (default cuda; without a card and without
``--device cpu`` it exits non-zero).  The checkpoint is a reference
``.pth`` or a native ``.ckpt``, loaded by ``infer_cli.load_model``.
svs_tpu enables its persistent XLA compile cache here; the port compiles
nothing ahead of a call (cuDNN picks its algorithms at the first call of
each shape), so there is no counterpart: ``--warmup_secs`` is what makes
the first request of a length bucket warm.

SIGTERM drains the queue and stops the accept loop; ``main`` then waits
at most ``--request_timeout`` seconds for the responses still being
written (never for an idle client connection) and returns 0.

Run as ``python -m svs_torch.cli.serve_cli``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve vocal separation over "
                                            "HTTP (POST /separate).")
    p.add_argument("--model_path", type=str, required=True,
                   help="native .ckpt or reference-format .pth checkpoint")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--preset", type=str, default="default")
    p.add_argument("--dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="override the preset's conv compute dtype (the "
                        "shipped presets run bfloat16)")
    p.add_argument("--max_batch", type=int, default=8,
                   help="max requests coalesced into one pipelined "
                        "device call per queue drain")
    p.add_argument("--max_body_mb", type=int, default=256,
                   help="reject request bodies above this size (413)")
    p.add_argument("--max_queue", type=int, default=32,
                   help="max pending requests; beyond this new requests "
                        "fast-fail with 503 + Retry-After")
    p.add_argument("--request_timeout", type=float, default=300.0,
                   help="per-request deadline in seconds (504 on expiry)")
    p.add_argument("--warmup_secs", type=float, default=0.0,
                   help="separate a silent song of this length on the "
                        "worker thread BEFORE binding the port (size it "
                        "like a typical song)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the host)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import dataclasses

    from svs_torch.cli.infer_cli import load_model
    from svs_torch.serve.server import close, install_sigterm_drain, serve
    from svs_torch.utils.config import get_config
    from svs_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.preset)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    model = load_model(args.model_path, cfg, device)
    httpd = serve(model, host=args.host, port=args.port,
                  max_body_bytes=args.max_body_mb << 20,
                  max_batch=args.max_batch,
                  max_queue=args.max_queue,
                  request_timeout=args.request_timeout,
                  warmup_secs=args.warmup_secs, device=device)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          "(POST /separate, GET /healthz)", flush=True)

    install_sigterm_drain(httpd, drain_timeout=args.request_timeout)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        close(httpd, timeout=args.request_timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
