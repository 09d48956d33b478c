"""The benchmark's harness: the cells, configurations, traffic mixes and
loops found by name (cells.py), the keys, targets and samples drawn from
the seed (seeds.py), the timed window every loop shares (driving.py),
the profiler's reading (profile.py), the roofline arithmetic
(roofline.py), the comparison with the plain reference that decides
``correct`` (verdict.py) and the planted faults (faults.py)."""
