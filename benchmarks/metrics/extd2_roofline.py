"""extd2_roofline: the least time of the window's extd2 launches
(roofline/extd2.py from each launch's job lengths, against the peaks in
roofline/__init__.py) over their profiled kernel time, in percent."""


def read(rec):
    if rec["extd2_us"] <= 0:
        return None
    return 100.0 * rec["extd2_bound_us"] / rec["extd2_us"]
