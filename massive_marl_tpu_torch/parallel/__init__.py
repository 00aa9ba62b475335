"""Data parallelism over ranks (twin of massive_marl_tpu/parallel/):
mesh.py holds the mesh and its collectives, launch.py starts the processes
of a job on one host."""
