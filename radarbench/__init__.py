"""The benchmark of ``navtech_radar_slam_torch`` on an NVIDIA H100.

``python -m radarbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell is made of is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (read by the runner
it names, ``runners/<runner>.py``), ``metrics/<metric>.py``, and the
limits of its output check, ``checks/<workload>.json``.  ``reference/`` is
the plain reference, ``counts/`` the frozen roofline arithmetic.
"""
