"""The benchmark's plain reference: a frozen copy of the port's plain
path (the scene compiler, the camera, the counter-hash RNG, the shading,
textures and lights) with a phase A of its own over the scene's tables
and the dense bounce loop.  It imports nothing of the port: it compiles
the configuration's scene itself, and the gradients of a train step come
from reverse-mode autograd of the dense loop, not from a tape.

``render.sampled_sum`` and ``train.follow`` are what the harness compares
the port's timed path with.
"""
