"""Render node: the ``mtssrv`` command (``mitsuba_im_tpu/cli/mtssrv.py``;
Mitsuba's ``mtssrv.cpp`` accept loop and its ``-ls`` stdin mode for SSH
tunnelling).

    python -m mitsuba_im_tpu_torch.cli.mtssrv [-p PORT] [-i HOST] [-q]
    python -m mitsuba_im_tpu_torch.cli.mtssrv -ls  # over stdin/stdout

The node renders on ``--device`` (the card by default; without one it
raises, and ``--device cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mitsuba_im_tpu_torch.cli.mtssrv",
                                 description=__doc__)
    ap.add_argument("-p", dest="port", type=int, default=None,
                    help="listen port (default 7554)")
    ap.add_argument("-i", dest="host", default="",
                    help="interface to bind (default: all)")
    ap.add_argument("-ls", dest="stdio", action="store_true",
                    help="serve a single connection over stdin/stdout")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..core.types import entry_device
    from ..parallel import remote

    device = entry_device(args.device)
    log = (lambda *_: None) if args.quiet else (
        lambda *a: print("[mtssrv]", *a, file=sys.stderr, flush=True))
    if args.stdio:
        remote.serve_stdio(log=log, device=device)
    else:
        remote.serve_tcp(port=args.port or remote.DEFAULT_PORT,
                         host=args.host, log=log, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
