"""How PyTorch's f32 ``sqrt`` and f32 matmul behave on the CPU, repeated in
fresh processes (not a test: the figures behind ROADMAP.md C's note on the
front ends' plain versions and behind
``test_torch_fft_frontend.py::test_cpu_f32_sqrt_is_within_one_ulp_of_the_rounded_root``).

    python tests/torch_cpu_sqrt_stress.py [--procs 6] [--iters 100]

Each worker process (8 torch threads, all started together) takes the f32
root of a (513, 2731) power plane, the decode shape's, ``--iters`` times
and prints how many outputs differ from the correctly rounded root (float64,
rounded once), the largest difference in ulps, and whether every call gave
the first call's bits; the same for a (2731, 1024) x (1024, 1024) f32
matmul against its first call.  A fault that only shows under load would
show as a larger ulp count or a call that does not repeat.
"""

import argparse
import subprocess
import sys

import numpy as np
import torch


def worker(seed: int, iters: int) -> None:
    torch.set_num_threads(8)
    rng = np.random.default_rng(seed)
    re, im = (torch.from_numpy((rng.standard_normal((513, 2731)) * 7).astype(
        np.float32)) for _ in range(2))
    power = re * re + im * im
    want = torch.sqrt(power.double()).float()
    a = torch.from_numpy(rng.standard_normal((2731, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1024, 1024)).astype(np.float32))
    first_root, first_mm = torch.sqrt(power), a @ b
    ulps = (first_root.view(torch.int32) - want.view(torch.int32)).abs()
    root_repeats = mm_repeats = True
    for _ in range(iters):
        root_repeats &= torch.equal(torch.sqrt(power), first_root)
        mm_repeats &= torch.equal(a @ b, first_mm)
    print(f"seed {seed}: sqrt off the rounded root in "
          f"{(ulps > 0).double().mean().item():.4%} of {power.numel()} "
          f"outputs, at most {ulps.max().item()} ulp; repeats over {iters} "
          f"calls: sqrt {root_repeats}, matmul {mm_repeats}", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=6)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--worker", type=int, default=None)
    args = p.parse_args()
    if args.worker is not None:
        worker(args.worker, args.iters)
        return
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(s),
                               "--iters", str(args.iters)])
             for s in range(args.procs)]
    sys.exit(max(p.wait() for p in procs))


if __name__ == "__main__":
    main()
