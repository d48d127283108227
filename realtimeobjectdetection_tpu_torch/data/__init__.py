from .classnames import COCO80, VOC20, load_classes  # noqa: F401
