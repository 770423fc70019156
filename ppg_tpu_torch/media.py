"""Participating media (counterpart of ppg_tpu/media.py). Only the
phase-function sentinels the scene loader writes into a medium's g slot
are here; the media themselves are not ported yet (ROADMAP Queue 1
item 4)."""

RAYLEIGH_G = 2.0  # g-slot sentinel: Rayleigh phase (rayleigh.cpp)
KKAY_G = 3.0  # g-slot sentinel: Kajiya-Kay fiber phase (kkay.cpp)
MICROFLAKE_G = 5.0  # g-slot sentinel: SGGX microflake fiber phase
