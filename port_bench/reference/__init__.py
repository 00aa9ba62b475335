"""The plain reference that decides `correct`: TenAnt (tenant.py) and PPO
(ppo.py) in plain PyTorch, and the comparison (compare.py).  It imports
nothing of the port and takes nothing the port made: the benchmark hands
both sides the same weights and seeds, and everything else is worked out
here again."""
