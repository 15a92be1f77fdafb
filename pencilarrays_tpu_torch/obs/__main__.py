"""``python -m pencilarrays_tpu_torch.obs``: the JAX package's ``pa-obs``
command line, not ported yet (ROADMAP Queue 1 item 7(b))."""

from . import _LATER

raise SystemExit(f"pa-obs is {_LATER}")
