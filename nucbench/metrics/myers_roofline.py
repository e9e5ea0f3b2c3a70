"""``myers_roofline`` (%): the frozen ``myers_ops`` floor of the text
the traced window scanned, at the card's integer issue rate, over kernel
#19's device time there; nothing where the profile lost a launch."""

from nucbench import roofline

TAGS = ("myers_",)
WRAPPERS = ("myers_scan",)


def read(trace):
    ops = trace.work.get("myers_floor_ops", 0)
    t = trace.kernel_s(*TAGS)
    if not trace.complete(TAGS, WRAPPERS) or ops <= 0 or t <= 0:
        return None
    return 100.0 * roofline.bound_s(0, ops) / t
