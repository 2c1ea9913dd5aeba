"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or fill runs on the card. The stretch runs from the host start of its
first frame to the end of its last frame's last device operation; the
busy time is the union of the device intervals in it."""


def read(view):
    busy = view.busy_us()
    if busy is None:
        return None
    s, e = view.stretch
    return 100.0 * (1.0 - busy / (e - s))
