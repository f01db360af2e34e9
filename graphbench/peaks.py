"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet for the H100
SXM: 3.35 TB/s of HBM3 at the full 700 W power limit; a run prints the
card's limit beside its numbers)."""

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
