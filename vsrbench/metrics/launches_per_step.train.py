"""Device kernels launched a step in the traced window (copies and memsets
not counted)."""


def read(rec):
    if "kernels" not in rec or not rec["kernels"]:
        return None
    return len(rec["kernels"]) / rec["steps"]
