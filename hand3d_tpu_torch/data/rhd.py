"""RHD (Rendered Handpose Dataset) reader (a copy of hand3d_tpu/data/rhd.py).

Reads the rhd_{training,evaluation}.bin files of the reference's converter
(layout in ``data.codec``). Sample counts per data/BinaryDbReader.py:59-64.
"""

from hand3d_tpu_torch.data.codec import FixedLenRecordFile, RHD_RECORD_DTYPE

NUM_SAMPLES = {"training": 41258, "evaluation": 2728}
DEFAULT_PATHS = {
    "training": "./data/bin/rhd_training.bin",
    "evaluation": "./data/bin/rhd_evaluation.bin",
}


class RHDDataset:
    def __init__(self, mode, path=None):
        if mode not in NUM_SAMPLES:
            raise ValueError(f"Unknown dataset mode: {mode}")
        self.mode = mode
        self.path = path or DEFAULT_PATHS[mode]
        self.records = FixedLenRecordFile(self.path, RHD_RECORD_DTYPE)
        self.num_samples = len(self.records)
        if path is None and self.num_samples != NUM_SAMPLES[mode]:
            # an explicit path may hold a subset; the default official file
            # must have the reference count, or every metric shifts
            raise ValueError(
                f"{self.path} has {self.num_samples} records, expected "
                f"{NUM_SAMPLES[mode]} for RHD {mode} "
                "(BinaryDbReader.py:59-64); truncated or wrong-mode file?")

    def __len__(self):
        return self.num_samples

    FIELDS = ("kp_xyz", "kp_uv", "cam_mat", "image", "hand_parts", "kp_vis")

    @classmethod
    def raw_from_records(cls, recs):
        """A structured record array as the dict of its fields."""
        return {k: recs[k] for k in cls.FIELDS}

    def raw_batch(self, indices):
        """The records as a dict of numpy arrays (host side)."""
        return self.raw_from_records(self.records.gather(indices))
