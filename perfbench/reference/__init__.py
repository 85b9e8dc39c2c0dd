"""The benchmark's plain references: float32 PyTorch, written from the
published architectures and the port's documented rules (resize weights,
dropout bits, seeding), and nothing else. These modules import ``torch``
and ``numpy`` only: never ``jax``, ``vimoclip_tpu`` or
``vimoclip_tpu_torch``. They decide ``correct``; the program's outputs are
read only to be judged."""
