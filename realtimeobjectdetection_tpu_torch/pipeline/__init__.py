from .detector import DetectorV3  # noqa: F401
