"""The benchmark's plain reference of the env step: a frozen copy of the
port's plain engine, hand model, action pipeline, observations, rewards,
termination, masked reset and factory, of the two tasks the benchmark runs
(BlindGrasping, BoxStacking, and BaseTask under them) and of the JSON
config files their configurations load, taken at commit dadcd0d. It
imports nothing of the port.

Edits against the port's files: imports renamed into this package; the
factory builds the built-in hand only and projects spawns with the plain
engine's `min_site_z`; `HandPhysics.make_control_step` is the plain control
step; `ops/linalg.py` keeps the plain solve; `parallel/mesh.py` and
`utils/device.py` are one-process stand-ins; `DexHandEnv.make_fused`, the
other tasks and the configs no cell loads are gone. Everything else is the port's code as it was, so the reference steps
what the port's plain step computed at that commit.
"""
