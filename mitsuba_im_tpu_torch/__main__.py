"""``python -m mitsuba_im_tpu_torch scene.xml [options]``: the batch render
command line (``cli/main.py``)."""
import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
