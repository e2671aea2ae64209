"""Gain-solution files: HDF5, ``.npz`` and losoto/DP3 h5parm.

Counterpart of ``ska_sdp_func_python_tpu/io/gainio.py``, with the same
layouts and the same format tag, so a file written by either package
loads in the other.

Layout (HDF5): one group per table (default ``sol000``, after the h5parm
convention), datasets ``gain`` [ntime, nants, nchan, nrec, nrec]
complex64, ``weight``, ``residual``, ``time``, ``interval``,
``frequency``, plus ``amplitude``/``phase`` views, with ``jones_type``
and ``receptor_frame`` as attributes. ``.npz`` files hold the same
arrays under ``<name>.<field>`` keys. A dict of tables (a calibration
chain, e.g. ``{"T": gt_t, "G": gt_g}``) goes through one file.

``h5py`` is imported only by the HDF5 branches: ``.npz`` files need
nothing but numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import resolve_device
from ..models.gaintable import GainTable
from .visio import _host

__all__ = [
    "save_gaintable",
    "load_gaintable",
    "save_gaintables",
    "load_gaintables",
    "export_h5parm",
    "import_h5parm",
]

_FIELDS = ("gain", "weight", "residual", "time", "interval", "frequency")
_FORMAT = "ska-sdp-func-python-tpu gaintable v1"


def _is_hdf5(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".h5", ".hdf5", ".h5parm")


def _arrays(gt: GainTable) -> dict:
    out = {f: _host(getattr(gt, f)) for f in _FIELDS}
    out["gain"] = out["gain"].astype(np.complex64)
    return out


def _table(arrays: dict, jones_type: str, receptor_frame: str, device) -> GainTable:
    """A GainTable on ``device`` from host arrays, the time axes in f64."""
    t = {f: torch.as_tensor(np.array(arrays[f]), device=device) for f in _FIELDS}
    for f in ("time", "interval"):
        t[f] = t[f].to(torch.float64)
    return GainTable(**t, jones_type=jones_type, receptor_frame=receptor_frame)


def save_gaintables(tables: dict, path: str) -> None:
    """Save a ``{name: GainTable}`` dict to ``path`` (.h5/.hdf5/.h5parm
    HDF5, anything else npz)."""
    if _is_hdf5(path):
        import h5py

        with h5py.File(path, "w") as fh:
            fh.attrs["format"] = _FORMAT
            for name, gt in tables.items():
                grp = fh.create_group(name)
                arrs = _arrays(gt)
                for f in _FIELDS:
                    grp.create_dataset(f, data=arrs[f])
                grp.create_dataset("amplitude", data=np.abs(arrs["gain"]))
                grp.create_dataset("phase", data=np.angle(arrs["gain"]))
                grp.attrs["jones_type"] = gt.jones_type
                grp.attrs["receptor_frame"] = gt.receptor_frame
        return
    blob = {}
    for name, gt in tables.items():
        arrs = _arrays(gt)
        for f in _FIELDS:
            blob[f"{name}.{f}"] = arrs[f]
        blob[f"{name}.jones_type"] = np.str_(gt.jones_type)
        blob[f"{name}.receptor_frame"] = np.str_(gt.receptor_frame)
    np.savez(path, **blob)


def load_gaintables(path: str, device=None) -> dict:
    """Load a ``{name: GainTable}`` dict saved by :func:`save_gaintables`
    (of either package), its tensors on ``device`` (None: the CUDA
    card)."""
    device = resolve_device(device)
    out = {}
    if _is_hdf5(path):
        import h5py

        with h5py.File(path, "r") as fh:
            for name in fh:
                grp = fh[name]
                out[name] = _table(
                    {f: np.asarray(grp[f]) for f in _FIELDS},
                    str(grp.attrs["jones_type"]),
                    str(grp.attrs["receptor_frame"]),
                    device,
                )
        return out
    with np.load(path, allow_pickle=False) as data:
        names = sorted({k.split(".", 1)[0] for k in data.files})
        for name in names:
            out[name] = _table(
                {f: data[f"{name}.{f}"] for f in _FIELDS},
                str(data[f"{name}.jones_type"]),
                str(data[f"{name}.receptor_frame"]),
                device,
            )
    return out


def save_gaintable(gt: GainTable, path: str, name: str = "sol000") -> None:
    """Save one gaintable (an h5parm-style single solset)."""
    save_gaintables({name: gt}, path)


def load_gaintable(path: str, name: str | None = None, device=None) -> GainTable:
    """Load one gaintable; ``name=None`` takes the only table."""
    tables = load_gaintables(path, device=device)
    if name is not None:
        return tables[name]
    if len(tables) != 1:
        raise ValueError(f"{path} holds {sorted(tables)}; pass name= to pick one")
    return next(iter(tables.values()))


# h5parm, the format the LOFAR/SKA tools read solutions in (losoto's
# H5parm class, DP3), after losoto's H5parm v1 conventions:
#   /<solset>/antenna           compound [(name S64, position f64[3])]
#   /<solset>/source            compound [(name S128, dir f64[2])]
#   /<solset>/phase000/val      f4, axes in val.attrs['AXES']
#                    /weight    f4 (same axes)
#                    /time f8, /ant S64, /freq f8, /dir S128, /pol S8
#   /<solset>/amplitude000/...  the same, TITLE='amplitude'

_H5PARM_AXES = b"time,ant,freq,dir,pol"


def _pol_labels(g: np.ndarray, full_jones: bool | None):
    if full_jones is None:
        off = 0.0
        if g.shape[-1] == 2:
            off = float(np.max(np.abs(g[..., 0, 1]))) + float(
                np.max(np.abs(g[..., 1, 0]))
            )
        full_jones = off > 0.0
    if g.shape[-1] == 1:
        return [b"XX"], False
    if full_jones:
        return [b"XX", b"XY", b"YX", b"YY"], True
    return [b"XX", b"YY"], False


def export_h5parm(
    tables: dict | GainTable,
    path: str,
    solset: str = "sol000",
    antenna_names=None,
    antenna_positions=None,
    source_dir=(0.0, 0.0),
    full_jones: bool | None = None,
) -> None:
    """Write gaintables as a losoto/DP3-compatible h5parm file.

    :param tables: one GainTable or a ``{name: GainTable}`` chain; each
        term gets its own ``phase###``/``amplitude###`` soltab pair
    :param antenna_names: [nants] strings; default ``ANT000..``
    :param antenna_positions: [nants, 3] ITRF metres; default zeros
    :param source_dir: (ra, dec) rad recorded in the source table
    :param full_jones: force the 4-pol (XX, XY, YX, YY) export; None
        decides from the off-diagonal gains
    """
    import h5py

    if isinstance(tables, GainTable):
        tables = {"sol": tables}
    with h5py.File(path, "w") as fh:
        ss = fh.create_group(solset)
        nants = next(iter(tables.values())).nants
        names = (
            [f"ANT{i:03d}" for i in range(nants)]
            if antenna_names is None
            else list(antenna_names)
        )
        pos = (
            np.zeros((nants, 3), np.float64)
            if antenna_positions is None
            else np.asarray(antenna_positions, np.float64)
        )
        ant_dt = np.dtype([("name", "S64"), ("position", "<f8", (3,))])
        ant_tab = np.zeros(nants, ant_dt)
        ant_tab["name"] = [str(n).encode() for n in names]
        ant_tab["position"] = pos
        ss.create_dataset("antenna", data=ant_tab)
        src_dt = np.dtype([("name", "S128"), ("dir", "<f8", (2,))])
        src_tab = np.zeros(1, src_dt)
        src_tab["name"] = [b"pointing"]
        src_tab["dir"] = [np.asarray(source_dir, np.float64)]
        ss.create_dataset("source", data=src_tab)

        for i, (term, gt) in enumerate(tables.items()):
            g = _host(gt.gain).astype(np.complex64)
            w = _host(gt.weight).astype(np.float32)
            pols, fj = _pol_labels(g, full_jones)
            if g.shape[-1] == 1:
                vals = g[..., 0, 0][..., None]
                wv = w[..., 0, 0][..., None]
            elif fj:
                sh = g.shape[:-2] + (4,)
                vals = g.reshape(sh)
                wv = w.reshape(sh)
            else:
                vals = np.stack([g[..., 0, 0], g[..., 1, 1]], axis=-1)
                wv = np.stack([w[..., 0, 0], w[..., 1, 1]], axis=-1)
            # [time, ant, freq, pol] -> the dir axis before pol
            vals = vals[:, :, :, None, :]
            wv = wv[:, :, :, None, :].astype(np.float32)
            for kind, data in (
                ("phase", np.angle(vals).astype(np.float32)),
                ("amplitude", np.abs(vals).astype(np.float32)),
            ):
                st = ss.create_group(f"{kind}{i:03d}")
                st.attrs.create("TITLE", np.bytes_(kind))
                st.attrs["jones_type"] = gt.jones_type
                st.attrs["term"] = term
                v = st.create_dataset("val", data=data)
                v.attrs.create("AXES", np.bytes_(_H5PARM_AXES))
                wd = st.create_dataset("weight", data=wv)
                wd.attrs.create("AXES", np.bytes_(_H5PARM_AXES))
                st.create_dataset("time", data=_host(gt.time).astype(np.float64))
                st.create_dataset("ant", data=ant_tab["name"])
                st.create_dataset(
                    "freq", data=_host(gt.frequency).astype(np.float64)
                )
                st.create_dataset("dir", data=np.asarray([b"pointing"]))
                st.create_dataset("pol", data=np.asarray(pols, dtype="S8"))


def import_h5parm(path: str, solset: str = "sol000", device=None) -> dict:
    """Read an h5parm written by :func:`export_h5parm` (of either
    package, or any file after the same conventions) into ``{term:
    GainTable}`` on ``device`` (None: the CUDA card). Amplitude and phase
    soltabs of one number combine into complex gains; a missing amplitude
    is 1."""
    import h5py

    device = resolve_device(device)
    out = {}
    with h5py.File(path, "r") as fh:
        ss = fh[solset]
        nums = sorted({k[-3:] for k in ss if k.startswith(("phase", "amplitude"))})
        for num in nums:
            ph = ss.get(f"phase{num}")
            am = ss.get(f"amplitude{num}")
            ref = ph if ph is not None else am
            phase = np.asarray(ph["val"]) if ph is not None else 0.0
            amp = np.asarray(am["val"]) if am is not None else 1.0
            vals = (amp * np.exp(1j * phase))[:, :, :, 0, :]  # [t, ant, f, pol]
            wv = np.asarray(ref["weight"])[:, :, :, 0, :]
            npol = vals.shape[-1]
            nt, na, nf = vals.shape[:3]
            if npol == 4:
                gain = vals.reshape(nt, na, nf, 2, 2)
                weight = wv.reshape(nt, na, nf, 2, 2)
            elif npol == 2:
                gain = np.zeros((nt, na, nf, 2, 2), np.complex64)
                gain[..., 0, 0] = vals[..., 0]
                gain[..., 1, 1] = vals[..., 1]
                weight = np.zeros((nt, na, nf, 2, 2), np.float32)
                weight[..., 0, 0] = wv[..., 0]
                weight[..., 1, 1] = wv[..., 1]
            else:
                gain = vals[..., None]
                weight = wv[..., None]
            time = np.asarray(ref["time"], np.float64)
            dt = np.diff(time)
            interval = (
                np.concatenate([dt, dt[-1:]]) if len(time) > 1 else np.ones_like(time)
            )
            nrec = gain.shape[-1]
            term = ref.attrs.get("term", f"sol{num}")
            term = term if isinstance(term, str) else term.decode()
            out[term] = _table(
                {
                    "gain": gain.astype(np.complex64),
                    "weight": weight.astype(np.float32),
                    "residual": np.zeros((nt, nf, nrec, nrec), np.float32),
                    "time": time,
                    "interval": interval,
                    "frequency": np.asarray(ref["freq"], np.float64),
                },
                str(ref.attrs.get("jones_type", "T")),
                "linear",
                device,
            )
    return out
