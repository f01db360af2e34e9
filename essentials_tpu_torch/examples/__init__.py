"""Example drivers of the port (``python -m essentials_tpu_torch.examples.run_all``)."""
