"""Post-hoc log tooling (twin of massive_marl_tpu/utils/logger/): tools.py
converts and merges the trainers' metrics, plotter.py draws them."""
