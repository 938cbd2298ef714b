"""Minimal binary-little-endian PLY reader/writer (numpy only).

The port's own copy of ``frosting_tpu/utils/ply.py`` (binary only), so the
port imports nothing of the JAX package. Covers the 3DGS checkpoint format
(gaussian_splatting/scene/gaussian_model.py:191-256) and general point-cloud
and mesh I/O: float32/float64/uint8 scalar vertex properties and int32 face
lists.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "int16": "<i2",
    "ushort": "<u2",
    "uint16": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}
_PLY_NAMES = {
    "<f4": "float",
    "<f8": "double",
    "u1": "uchar",
    "<i4": "int",
    "<u4": "uint",
}


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a binary little-endian PLY. Returns {element: {property: array}};
    list properties (e.g. face vertex_indices) come back as [n, k] arrays
    when fixed-size, else object arrays."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = "binary_little_endian"
    elements: List[Tuple[str, int, List[Tuple[str, str, Optional[str]]]]] = []
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _DTYPES[parts[3]], _DTYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _DTYPES[parts[1]], None))

    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    offset = 0
    for name, count, props in elements:
        has_list = any(p[2] is not None for p in props)
        if not has_list:
            dt = np.dtype([(p[0], p[1]) for p in props])
            arr = np.frombuffer(body, dt, count=count, offset=offset)
            offset += dt.itemsize * count
            out[name] = {p[0]: np.ascontiguousarray(arr[p[0]]) for p in props}
        elif len(props) == 1 and _fixed_list(body, offset, count, props[0]) is not None:
            # one list property whose every row has the same length (a
            # triangle mesh's faces): one structured read
            rec = _fixed_list(body, offset, count, props[0])
            offset += rec.nbytes
            out[name] = {props[0][0]: np.ascontiguousarray(rec["v"])}
        else:
            # assume homogeneous list sizes (true for triangle meshes)
            cols: Dict[str, list] = {p[0]: [] for p in props}
            view = memoryview(body)
            for _ in range(count):
                for pname, pdt, cnt_dt in props:
                    if cnt_dt is not None:
                        k = int(np.frombuffer(view, cnt_dt, 1, offset)[0])
                        offset += np.dtype(cnt_dt).itemsize
                        cols[pname].append(
                            np.frombuffer(view, pdt, k, offset).copy()
                        )
                        offset += np.dtype(pdt).itemsize * k
                    else:
                        cols[pname].append(
                            np.frombuffer(view, pdt, 1, offset)[0]
                        )
                        offset += np.dtype(pdt).itemsize
            out[name] = {}
            for k, v in cols.items():
                if v and isinstance(v[0], np.ndarray):
                    sizes = {len(x) for x in v}
                    out[name][k] = (
                        np.stack(v) if len(sizes) == 1 else np.array(v, object)
                    )
                else:
                    out[name][k] = np.array(v)
    return out


def _fixed_list(body, offset, count, prop):
    """The rows of an element made of one list property as a structured
    array of (count, values), if every row holds as many values as the
    first; else None."""
    _name, pdt, cnt_dt = prop
    if count == 0 or offset + np.dtype(cnt_dt).itemsize > len(body):
        return None
    k = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
    dt = np.dtype([("n", cnt_dt), ("v", pdt, (k,))])
    if offset + dt.itemsize * count > len(body):
        return None
    rec = np.frombuffer(body, dt, count=count, offset=offset)
    return rec if np.all(rec["n"] == k) else None


def write_ply(
    path: str,
    vertex_props: Dict[str, np.ndarray],
    faces: Optional[np.ndarray] = None,
    comment: str = "frosting-tpu",
) -> None:
    """Write a binary-little-endian PLY. vertex_props: {name: [n] array}
    (order preserved — required for 3DGS-viewer compatibility). faces:
    optional [m, 3] int array."""
    names = list(vertex_props)
    n = len(vertex_props[names[0]])
    arrays = []
    fields = []
    for name in names:
        a = np.asarray(vertex_props[name])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        dt = a.dtype.str.lstrip("=|")
        if dt not in _PLY_NAMES:
            a = a.astype(np.float32)
            dt = "<f4"
        arrays.append(a)
        fields.append((name, dt))

    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"comment {comment}\n".encode())
    buf.write(f"element vertex {n}\n".encode())
    for name, dt in fields:
        buf.write(f"property {_PLY_NAMES[dt]} {name}\n".encode())
    if faces is not None:
        buf.write(f"element face {len(faces)}\n".encode())
        buf.write(b"property list uchar int vertex_indices\n")
    buf.write(b"end_header\n")

    rec = np.zeros(n, dtype=[(name, dt) for name, dt in fields])
    for (name, _dt), a in zip(fields, arrays):
        rec[name] = a
    buf.write(rec.tobytes())

    if faces is not None:
        faces = np.asarray(faces, np.int32)
        frec = np.zeros(
            len(faces), dtype=[("k", "u1"), ("v", "<i4", (faces.shape[1],))]
        )
        frec["k"] = faces.shape[1]
        frec["v"] = faces
        buf.write(frec.tobytes())

    with open(path, "wb") as f:
        f.write(buf.getvalue())
