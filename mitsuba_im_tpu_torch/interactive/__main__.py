"""``python -m mitsuba_im_tpu_torch.interactive scene.xml [--device cpu]``:
the interactive terminal shell (``shell.py``)."""
from .shell import main

if __name__ == "__main__":
    raise SystemExit(main())
