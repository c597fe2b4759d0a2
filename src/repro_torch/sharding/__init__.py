from repro_torch.sharding.specs import DeviceRing, batch_devices  # noqa: F401
