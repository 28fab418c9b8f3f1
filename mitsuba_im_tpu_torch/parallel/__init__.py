"""Rendering across processes (``mesh.py``, a ``torch.distributed``
group) and across render nodes (``remote.py``, the ``mtssrv`` protocol)."""
