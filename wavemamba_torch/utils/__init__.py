"""Image IO, colour conversion and filesystem helpers."""

from wavemamba_torch.utils.color import ycbcr2bgr, ycbcr2rgb
from wavemamba_torch.utils.img_util import crop_border

__all__ = ["crop_border", "ycbcr2bgr", "ycbcr2rgb"]
