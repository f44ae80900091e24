"""Typed preprocessing config (a copy of hand3d_tpu/data/config.py).

Replaces the reference's reader-constructor keyword arguments
(BinaryDbReader.__init__, data/BinaryDbReader.py:32-99) with a frozen
dataclass.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    # semantics and defaults of BinaryDbReader.__init__ (:32-99)
    use_wrist_coord: bool = True
    sigma: float = 25.0
    hand_crop: bool = False
    random_crop_to_size: bool = False
    scale_to_size: bool = False
    hue_aug: bool = False
    coord_uv_noise: bool = False
    crop_center_noise: bool = False
    crop_scale_noise: bool = False
    crop_offset_noise: bool = False
    scoremap_dropout: bool = False
    # skip rendering the ground-truth scoremaps (harnesses that never read
    # them save the [B, H, W, 21] render)
    render_scoremap: bool = True

    # constants of the reference implementation
    crop_size: int = 256
    random_crop_size: int = 256
    scale_target_size: tuple = (240, 320)
    hue_aug_max: float = 0.1
    coord_uv_noise_sigma: float = 2.5
    crop_center_noise_sigma: float = 20.0
    crop_offset_noise_sigma: float = 10.0
    scoremap_dropout_prob: float = 0.8

    @property
    def needs_rng(self):
        return (self.hue_aug or self.coord_uv_noise or self.crop_center_noise
                or self.crop_scale_noise or self.crop_offset_noise
                or self.scoremap_dropout or self.random_crop_to_size)
