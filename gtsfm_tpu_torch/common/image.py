"""Image container + EXIF-based intrinsics guessing + rescaling utilities.

Host-side numpy, carried over from gtsfm_tpu/common/image.py (reference
gtsfm/common/image.py and gtsfm/utils/images.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Fast-path overrides checked BEFORE the full ~3.6k-entry database
# (common/sensor_db.py). Kept for exact-model hits that the fuzzy DB
# matching would report as ambiguous.
SENSOR_WIDTHS_MM = {
    "NIKON D70": 23.7,
    "NIKON D100": 23.7,
    "NIKON D3100": 23.1,
    "CANON EOS 5D": 35.8,
    "CANON EOS 5D MARK II": 36.0,
    "CANON EOS 350D DIGITAL": 22.2,
    "CANON EOS 400D DIGITAL": 22.2,
    "CANON EOS DIGITAL REBEL XT": 22.2,
    "IPHONE 12": 5.76,
    "IPHONE 13": 5.76,
    "DEFAULT": 36.0,
}

DEFAULT_FOV_DEG = 55.0  # fallback prior when EXIF gives nothing


@dataclasses.dataclass
class Image:
    value_array: np.ndarray  # (H, W, 3) uint8 or (H, W)
    exif_data: dict | None = None
    file_name: str | None = None
    mask: np.ndarray | None = None

    @property
    def height(self) -> int:
        return self.value_array.shape[0]

    @property
    def width(self) -> int:
        return self.value_array.shape[1]

    def focal_from_exif(self) -> float | None:
        """Pixel focal length from EXIF (reference Image.get_intrinsics_from_exif).

        Priority: FocalLengthIn35mmFilm -> FocalLength + sensor DB.
        """
        exif = self.exif_data or {}
        f35 = exif.get("FocalLengthIn35mmFilm")
        max_size = max(self.width, self.height)
        if f35 and f35 > 0:
            return float(f35) / 36.0 * max_size
        f_mm = exif.get("FocalLength")
        if not f_mm or f_mm <= 0:
            return None
        make = str(exif.get("Make", "")).strip().upper()
        model = str(exif.get("Model", "")).strip().upper()
        name = f"{make} {model}".strip()
        sensor_mm = SENSOR_WIDTHS_MM.get(model) or SENSOR_WIDTHS_MM.get(name)
        if sensor_mm is None:
            # Full database lookup (reference SensorWidthDatabase.lookup).
            from gtsfm_tpu_torch.common import sensor_db

            sensor_mm = sensor_db.lookup(make, model)
        if sensor_mm is None:
            return None
        return float(f_mm) / sensor_mm * max_size

    def guess_intrinsics(self) -> np.ndarray:
        """Cal3Bundler params (f, 0, 0, u0, v0) from EXIF or FOV prior."""
        f = self.focal_from_exif()
        if f is None:
            f = max(self.width, self.height) / (2.0 * np.tan(np.deg2rad(DEFAULT_FOV_DEG) / 2.0))
        return np.asarray([f, 0.0, 0.0, self.width / 2.0, self.height / 2.0], np.float32)


def load_image(path: str) -> Image:
    """Load an RGB image + EXIF tags (reference utils/io.py load_image)."""
    from PIL import Image as PILImage
    from PIL.ExifTags import TAGS

    with PILImage.open(path) as im:
        exif = {}
        raw = im.getexif()
        if raw:
            for tag_id, val in raw.items():
                exif[TAGS.get(tag_id, tag_id)] = val
            # merge sub-IFD (holds FocalLength etc.)
            try:
                sub = raw.get_ifd(0x8769)
                for tag_id, val in sub.items():
                    exif[TAGS.get(tag_id, tag_id)] = val
            except Exception:  # a malformed sub-IFD leaves the base tags
                pass
        arr = np.asarray(im.convert("RGB"))
    return Image(value_array=arr, exif_data=exif, file_name=path.split("/")[-1])


def rescale_image(img: Image, max_resolution: int) -> tuple[Image, float]:
    """Downscale so the SHORT side == max_resolution if larger (reference
    utils/images.py resize semantics used by LoaderBase.get_image).

    Returns (image, scale) where new_size = round(old_size * scale).
    """
    from PIL import Image as PILImage

    h, w = img.height, img.width
    short = min(h, w)
    if short <= max_resolution:
        return img, 1.0
    scale = max_resolution / short
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pil = PILImage.fromarray(img.value_array)
    resized = np.asarray(pil.resize((nw, nh), PILImage.BILINEAR))
    mask = None
    if img.mask is not None:
        mask = np.asarray(
            PILImage.fromarray(img.mask).resize((nw, nh), PILImage.NEAREST)
        )
    return Image(resized, img.exif_data, img.file_name, mask), scale


def rescale_intrinsics(cal: np.ndarray, scale_u: float, scale_v: float | None = None) -> np.ndarray:
    """Scale Cal3Bundler params for a resized image."""
    if scale_v is None:
        scale_v = scale_u
    out = np.array(cal, np.float32)
    out[0] = cal[0] * (scale_u + scale_v) / 2.0
    out[3] = cal[3] * scale_u
    out[4] = cal[4] * scale_v
    return out


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) uint8/float -> float32 grayscale in [0, 1] (ITU-R 601)."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 3:
        arr = arr @ np.asarray([0.299, 0.587, 0.114], np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    return arr
