"""Mean host time of a train step's call, from the call to its return (the
enqueue), over the traced window, in ms."""


def read(rec):
    s = rec.get("enqueue_s")
    if "kernels" not in rec or not s:
        return None
    return 1e3 * sum(s) / len(s)
