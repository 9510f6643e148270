"""The benchmark's plain reference: the f64 operator, the rss rule, and a
frozen copy of the right-hand-side family.

Plain PyTorch only. Nothing here imports the program under test
(``amg_tpu_torch``), JAX or ``amg_tpu``, and nothing here takes what the
program made: the operator is built from the problem's definition.
"""
