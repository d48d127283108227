from . import boxes, decode, nms, letterbox  # noqa: F401
