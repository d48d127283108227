"""Letterbox preprocessing on the host (the JAX package's host paths).

The reference letterboxes on the host with OpenCV INTER_CUBIC onto a
128-gray canvas (src/util.py:349-372) and normalizes to CHW float in
[0, 1] (src/util.py:375-397).  Bit-parity with the golden outputs requires
the exact cv2 resize, so preprocessing stays on the host.  Canvases are
NHWC numpy arrays, the layout of the port's public functions.  cv2 is
imported where it is used.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "letterbox_params",
    "letterbox_params_round",
    "letterbox_host",
    "prep_image_host",
    "prep_image_host_u8",
    "unletterbox_boxes",
]


def letterbox_params(img_w: int, img_h: int, inp_dim: int):
    """Scale + offsets used by letterboxing and its inverse.

    Matches src/util.py:360-370: ``new_w = int(img_w * min(...))``.
    """
    scale = min(inp_dim / img_w, inp_dim / img_h)
    new_w = int(img_w * scale)
    new_h = int(img_h * scale)
    off_x = (inp_dim - new_w) // 2
    off_y = (inp_dim - new_h) // 2
    return scale, new_w, new_h, off_x, off_y


def letterbox_params_round(img_w: int, img_h: int, inp_dim: int):
    """Like :func:`letterbox_params` but with round() extents — the
    ultralytics AutoShape convention (the Darknet reference truncates,
    src/util.py:362-363; the two can differ by one pixel)."""
    scale = min(inp_dim / img_w, inp_dim / img_h)
    new_w = int(round(img_w * scale))
    new_h = int(round(img_h * scale))
    off_x = (inp_dim - new_w) // 2
    off_y = (inp_dim - new_h) // 2
    return scale, new_w, new_h, off_x, off_y


def unletterbox_boxes(rows: np.ndarray, img_w: int, img_h: int,
                      inp_dim: int, params_fn=letterbox_params,
                      coord_cols=(0, 1, 2, 3)) -> np.ndarray:
    """Map xyxy box columns from letterbox space back to original pixels
    (clamped).  ``params_fn`` picks the truncation (Darknet) or rounding
    (v5) geometry so the inverse matches the forward letterbox."""
    if rows is None or len(rows) == 0:
        return np.zeros((0, rows.shape[1] if rows is not None and
                         rows.ndim == 2 else 7), np.float32)
    scale, _, _, off_x, off_y = params_fn(img_w, img_h, inp_dim)
    x0, y0, x1, y1 = coord_cols
    out = np.asarray(rows, np.float32).copy()
    out[:, [x0, x1]] = np.clip((out[:, [x0, x1]] - off_x) / scale, 0, img_w)
    out[:, [y0, y1]] = np.clip((out[:, [y0, y1]] - off_y) / scale, 0, img_h)
    return out


def letterbox_host(img: np.ndarray, inp_dim: int) -> np.ndarray:
    """cv2 INTER_CUBIC letterbox onto a 128-gray canvas (parity path)."""
    import cv2
    img_h, img_w = img.shape[0], img.shape[1]
    _, new_w, new_h, off_x, off_y = letterbox_params(img_w, img_h, inp_dim)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_CUBIC)
    canvas = np.full((inp_dim, inp_dim, 3), 128, dtype=np.float64)
    canvas[off_y:off_y + new_h, off_x:off_x + new_w, :] = resized
    return canvas


def prep_image_host(img: np.ndarray, inp_dim: int,
                    mode: str = "BGR") -> np.ndarray:
    """Letterbox + normalize -> NHWC float32 [1, D, D, 3] in RGB order.

    ``mode`` names the *input* channel order (cv2.imread gives BGR); the
    output is always RGB, matching prep_image's flip (src/util.py:391-394).
    """
    if mode not in ("BGR", "RGB"):
        raise ValueError(f"mode must be BGR or RGB, got {mode!r}")
    canvas = letterbox_host(img, inp_dim)
    if mode == "BGR":
        canvas = canvas[:, :, ::-1]
    out = (canvas.astype(np.float32) / 255.0)[None]
    return np.ascontiguousarray(out)


def prep_image_host_u8(img: np.ndarray, inp_dim: int,
                       mode: str = "BGR") -> np.ndarray:
    """Letterbox to an RGB uint8 canvas [1, D, D, 3] (no normalization).

    Bit-identical to ``prep_image_host`` after a device-side ``/255``:
    cv2's INTER_CUBIC on uint8 input yields uint8, and the reference's
    128-gray canvas holds integral values (src/util.py:364-370), so
    deferring the float division to the device changes nothing while
    cutting host->device traffic 4x.
    """
    import cv2
    if mode not in ("BGR", "RGB"):
        raise ValueError(f"mode must be BGR or RGB, got {mode!r}")
    img_h, img_w = img.shape[0], img.shape[1]
    _, new_w, new_h, off_x, off_y = letterbox_params(img_w, img_h, inp_dim)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_CUBIC)
    canvas = np.full((inp_dim, inp_dim, 3), 128, dtype=np.uint8)
    canvas[off_y:off_y + new_h, off_x:off_x + new_w, :] = resized
    if mode == "BGR":
        canvas = canvas[:, :, ::-1]
    return np.ascontiguousarray(canvas[None])
