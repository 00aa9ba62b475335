"""Frozen copies of the port's plain physics (phys/maths.py, spatial.py,
system.py, mjcf.py, engine.py; ops/scalar_phys.py; envs/obs_math.py), with
their imports pointed at this folder, and the ant model (../assets/ant.xml).
The port may change its own; these stay as the benchmark's yardstick."""
