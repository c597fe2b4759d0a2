from repro_torch.sharding.specs import (  # noqa: F401
    DeviceRing, batch_devices, shard_devices)
