"""Serving tier: the single-stream Moby engine and its shared pieces."""
from repro_torch.serving.common import (ComponentTimes, FrameRecord,  # noqa: F401
                                        RunReport)
