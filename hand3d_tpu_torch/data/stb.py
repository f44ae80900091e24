"""STB (Stereo Hand Tracking Benchmark) reader (a copy of
hand3d_tpu/data/stb.py).

Reads the stb_eval.bin of the reference's MATLAB converter
(data/stb/write_binary_record.m): 6000 evaluation samples and no training
split (BinaryDbReaderSTB.py:54-63).
"""

from hand3d_tpu_torch.data.codec import FixedLenRecordFile, STB_RECORD_DTYPE

NUM_SAMPLES = {"evaluation": 6000}
DEFAULT_PATHS = {"evaluation": "./data/stb/stb_eval.bin"}


class STBDataset:
    def __init__(self, mode="evaluation", path=None):
        if mode != "evaluation":
            raise ValueError("The STB set is not for training!")
        self.mode = mode
        self.path = path or DEFAULT_PATHS[mode]
        self.records = FixedLenRecordFile(self.path, STB_RECORD_DTYPE)
        self.num_samples = len(self.records)
        if path is None and self.num_samples != NUM_SAMPLES[mode]:
            # the default official file must have the reference count
            # (BinaryDbReaderSTB.py:60-61)
            raise ValueError(
                f"{self.path} has {self.num_samples} records, expected "
                f"{NUM_SAMPLES[mode]} for STB {mode}; truncated file?")

    def __len__(self):
        return self.num_samples

    FIELDS = ("kp_xyz", "kp_uv_vis", "image")

    @classmethod
    def raw_from_records(cls, recs):
        """A structured record array as the dict of its fields."""
        return {k: recs[k] for k in cls.FIELDS}

    def raw_batch(self, indices):
        """The records as a dict of numpy arrays (host side)."""
        return self.raw_from_records(self.records.gather(indices))
