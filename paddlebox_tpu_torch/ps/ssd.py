"""The SSD spill tier's error type (the tier itself, ``ps/ssd.py`` of the
reference, is not ported yet). ``train/checkpoint.py`` raises it, as
``CheckpointCorruptError``, when a spill manifest's segment disagrees
with its recorded digest."""


class SegmentCorruptError(RuntimeError):
    """A segment file's content does not match the spill manifest —
    refuse to promote from it."""
