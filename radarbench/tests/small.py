"""Sizes a CPU test run can hold: the cells' traffic and configuration with
fewer streams, scans and features (every other width as the cell has it)."""

FLEET = [("traffic.streams", 4), ("traffic.lap_scans", 6),
         ("config.features.max_features", 256), ("config.features.max_matches", 128),
         ("config.registration.spectral_top_k", 128)]
