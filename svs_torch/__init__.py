"""PyTorch / CUDA port of svs_tpu for NVIDIA Hopper (H100).

Modules mirror ``svs_tpu``'s paths and names so each counterpart is easy to
find; the port imports ``torch`` and never ``jax`` or ``svs_tpu``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
