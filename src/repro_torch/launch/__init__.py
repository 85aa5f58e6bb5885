# Command-line entry points (run with python -m repro_torch.launch.<name>).
