from repro_torch.fault.inject import (POINTS, FaultEvent,  # noqa: F401
                                      FaultInjector, FaultRule,
                                      InjectedFault)
from repro_torch.fault.monitor import (ElasticController,  # noqa: F401
                                       Heartbeat, StepMonitor,
                                       StragglerEvent)
