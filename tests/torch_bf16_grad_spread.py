"""How far the bf16 narrow U-Net's train-mode input gradient moves under a
change of sum order or rounding point, on the CPU (not a test: the figures
behind the bound of ``test_torch_step.py::test_unet_input_gradient_matches_jax``).

    JAX_PLATFORMS=cpu python tests/torch_bf16_grad_spread.py

For weight and input seeds 0-2 it prints relative L2 and median |d| over the
largest gradient of: JAX jitted against JAX op by op; the port with oneDNN
convs against torch's native convs; the port against JAX; the port with
``torch.clamp`` as its ReLU (the fault repaired at the ReLU ties) against
the port.  Then it runs itself again with XLA's excess precision off.
"""

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import svs_torch.models.unet as tunet  # noqa: E402
from svs_torch.models import torch_import as t_import  # noqa: E402
from svs_torch.utils.config import SVSConfig as TConfig  # noqa: E402
from svs_tpu.models import unet as junet  # noqa: E402
from svs_tpu.utils.config import SVSConfig as JConfig  # noqa: E402

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              compute_dtype="bfloat16")
NO_EXCESS = "--xla_allow_excess_precision=false"


def spread(got, want):
    err = np.abs(got - want) / np.abs(want).max()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    return f"rel L2 {rel:.4f}, median {np.median(err):.3e}"


def port_grad(params, state, x, r, relu=torch.maximum):
    model = tunet.UNet(TConfig(**NARROW))
    model.load_state_dict(t_import.state_dict_from_jax(params, state))
    xt = torch.from_numpy(x).requires_grad_()
    tunet.torch.maximum, saved = relu, tunet.torch.maximum
    try:
        (model.train()(xt) * torch.from_numpy(r)).sum().backward()
    finally:
        tunet.torch.maximum = saved
    return xt.grad.numpy()


def main():
    jax.config.update("jax_platforms", "cpu")
    jcfg = JConfig(**NARROW)
    excess = NO_EXCESS not in os.environ.get("XLA_FLAGS", "")
    print(f"XLA excess precision {'on' if excess else 'off'}")
    for seed in range(3):
        params, state = jax.jit(junet.init, static_argnums=1)(
            jax.random.key(seed), jcfg)
        params = jax.tree.map(np.asarray, params)
        state = jax.tree.map(np.asarray, state)
        rng = np.random.default_rng(1 + seed)
        x = rng.random((2, 512, 128)).astype(np.float32)
        r = rng.standard_normal((2, 512, 128)).astype(np.float32)

        def jloss(v):
            mask, _ = junet.apply(params, state, v, train=True,
                                  dropout_rng=jax.random.key(0), cfg=jcfg)
            return jnp.sum(mask * r)

        eager = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
        jitted = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
        port = port_grad(params, state, x, r)
        clamp = port_grad(params, state, x, r,
                          lambda a, b: torch.clamp(a, min=0.0))
        torch.backends.mkldnn.enabled = False
        native = port_grad(params, state, x, r)
        torch.backends.mkldnn.enabled = True
        print(f"seed {seed}: JAX jitted vs op by op: {spread(jitted, eager)}"
              f" | port native vs oneDNN convs: {spread(native, port)}"
              f" | port vs JAX op by op: {spread(port, eager)}"
              f" | port vs JAX jitted: {spread(port, jitted)}"
              f" | clamp ReLU vs port: {spread(clamp, port)}")
    if excess:
        env = dict(os.environ, XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "") + " " + NO_EXCESS).strip())
        subprocess.run([sys.executable, os.path.abspath(__file__)], env=env,
                       check=True)


if __name__ == "__main__":
    main()
