from repro_torch.serving.engine import ModelReplica, ServeRequest  # noqa: F401
