"""build_roofline: the build layer's least time (roofline/bytes.py over
roofline/peaks.py) over the device-busy time inside its spans, percent."""


def read(view):
    return view.roofline_pct("build")
