"""Native IO: the chunked visibility store (``native/visio.cpp``) and
gain-solution files."""

from .gainio import (
    export_h5parm,
    import_h5parm,
    load_gaintable,
    load_gaintables,
    save_gaintable,
    save_gaintables,
)
from .visio import (
    VisStore,
    stream_visibility_chunks,
    write_visibility,
    write_visibility_arrays,
)

__all__ = [
    "VisStore",
    "stream_visibility_chunks",
    "write_visibility",
    "write_visibility_arrays",
    "save_gaintable",
    "export_h5parm",
    "import_h5parm",
    "load_gaintable",
    "save_gaintables",
    "load_gaintables",
]
