"""The reference's norms, one file each, found by the port's name for the
configuration's norm (``model.norm``, default "rmsnorm"): ``layout(d)``,
the norm's leaves, and ``apply(p, x, eps)``."""
