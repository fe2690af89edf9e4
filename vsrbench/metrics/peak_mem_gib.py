"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start: weights, gradients, Adam's
moments and activations, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None
