from .zoo import yolov3_spec, yolov3_tiny_spec, get_spec, to_cfg_text  # noqa: F401
