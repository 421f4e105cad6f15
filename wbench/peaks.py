"""Published peaks of the chips the benchmark runs on, against which a
kernel's share of its roofline is stated.

NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its full 700 W
power limit): device memory 3.35 TB/s; float32 outside the tensor cores
67 TFLOP/s.  A card set below 700 W reaches less; the run's `device`
carries the card's power limit beside every reading.
"""
H100_SXM = {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12}
