"""Video frames trained in the window over its wall time: from the first
timed step's enqueue to the device's completion of the last, which ends in
a synchronize (every frame of a word clip, the clip's length of a sentence
clip)."""


def read(rec):
    return rec["frames"] / rec["wall_s"] if "frames" in rec and rec["wall_s"] > 0 else None
