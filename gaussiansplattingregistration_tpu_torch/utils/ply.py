"""Self-contained PLY codec (numpy, no plyfile dependency).

Reads/writes binary-little-endian and ascii PLY files, with the 3DGS Gaussian
field layout used by the reference (`src/models/gaussian_model.py:98-185`)
and the sparse-point layout (x/y/z + red/green/blue [+ normals]) handled by
`load_sparse_pc` (`src/utils/file_loader.py:20-30`).

Point-cloud type sniffing mirrors `check_point_cloud_type`
(`src/utils/file_loader.py:69-78`): a `red` property means a
sparse/SfM input cloud, `f_dc_0` means a Gaussian cloud.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TO_NUMPY = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NUMPY_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


class PointCloudType(enum.Enum):
    """PLY content classes (`file_loader.py:12-17` semantics)."""

    SPARSE = "sparse"
    GAUSSIAN = "gaussian"
    UNKNOWN = "unknown"


@dataclasses.dataclass
class PlyElementData:
    name: str
    count: int
    properties: List[str]
    data: np.ndarray  # structured array


@dataclasses.dataclass
class PlyData:
    elements: Dict[str, PlyElementData]

    @property
    def vertex(self) -> PlyElementData:
        return self.elements["vertex"]


def _parse_header(f) -> Tuple[str, List[Tuple[str, int, List[Tuple[str, str]]]]]:
    """Returns (format, [(element_name, count, [(prop_name, dtype_str)])])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", errors="replace").strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == "format":
            fmt = tokens[1]
        elif key == "comment" or key == "obj_info":
            continue
        elif key == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif key == "property":
            if tokens[1] == "list":
                raise ValueError("list properties are not supported")
            elements[-1][2].append((tokens[-1], _PLY_TO_NUMPY[tokens[1]]))
        elif key == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format")
    return fmt, elements


def read_ply(path: str) -> PlyData:
    """Parse a PLY file into structured numpy arrays (no list properties)."""
    with open(path, "rb") as f:
        fmt, header_elements = _parse_header(f)
        out: Dict[str, PlyElementData] = {}
        if fmt == "binary_little_endian":
            for name, count, props in header_elements:
                dtype = np.dtype([(p, "<" + d) for p, d in props])
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
                out[name] = PlyElementData(name, count, [p for p, _ in props], data)
        elif fmt == "binary_big_endian":
            for name, count, props in header_elements:
                dtype = np.dtype([(p, ">" + d) for p, d in props])
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
                out[name] = PlyElementData(name, count, [p for p, _ in props], data)
        elif fmt == "ascii":
            text = f.read().decode("ascii").split()
            offset = 0
            for name, count, props in header_elements:
                ncol = len(props)
                vals = np.array(text[offset:offset + count * ncol], dtype=np.float64)
                offset += count * ncol
                vals = vals.reshape(count, ncol)
                dtype = np.dtype([(p, d) for p, d in props])
                data = np.empty(count, dtype=dtype)
                for i, (p, _) in enumerate(props):
                    data[p] = vals[:, i]
                out[name] = PlyElementData(name, count, [p for p, _ in props], data)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return PlyData(out)


def write_ply(path: str, arrays: Dict[str, np.ndarray], element: str = "vertex",
              binary: bool = True) -> None:
    """Write named columns (each [N] float/int array) as one PLY element.

    Column order follows dict insertion order.
    """
    names = list(arrays.keys())
    n = len(arrays[names[0]])
    dtype = np.dtype([(name, np.asarray(arrays[name]).dtype.str[1:]) for name in names])
    data = np.empty(n, dtype=dtype)
    for name in names:
        data[name] = np.asarray(arrays[name])

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element {element} {n}")
    for name in names:
        kind = np.dtype(data.dtype[name]).str[1:]
        header.append(f"property {_NUMPY_TO_PLY[kind]} {name}")
    header.append("end_header\n")

    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if binary:
            f.write(data.astype(np.dtype([(name, "<" + np.dtype(data.dtype[name]).str[1:]) for name in names])).tobytes())
        else:
            for row in data:
                f.write((" ".join(repr(float(v)) for v in row) + "\n").encode("ascii"))


def check_point_cloud_type(ply: PlyData) -> PointCloudType:
    """Sniff content type by property names (`file_loader.py:69-78`)."""
    props = ply.vertex.properties
    if "red" in props:
        return PointCloudType.SPARSE
    if "f_dc_0" in props:
        return PointCloudType.GAUSSIAN
    return PointCloudType.UNKNOWN


# --------------------------------------------------------------------------
# Gaussian cloud layer (3DGS field layout)
# --------------------------------------------------------------------------

def gaussian_arrays_from_ply(ply: PlyData):
    """Structured PLY -> dict of float32 arrays in GaussianCloud layout.

    Mirrors `GaussianModel.from_ply`
    (`src/models/gaussian_model.py:98-139`): SH degree is
    inferred from the f_rest count; f_rest is stored channel-major
    (3, K-1) per point and transposed to [N, K-1, 3].
    """
    v = ply.vertex.data
    n = len(v)
    xyz = np.stack([np.asarray(v["x"]), np.asarray(v["y"]), np.asarray(v["z"])], axis=1)
    opacity = np.asarray(v["opacity"], dtype=np.float32)[:, None]

    f_dc = np.stack(
        [np.asarray(v["f_dc_0"]), np.asarray(v["f_dc_1"]), np.asarray(v["f_dc_2"])], axis=1
    ).astype(np.float32)[:, None, :]  # [N, 1, 3]

    rest_names = sorted(
        (p for p in ply.vertex.properties if p.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    sh_len = len(rest_names)
    sh_degree = int(round(((sh_len + 3) / 3) ** 0.5)) - 1
    k_rest = (sh_degree + 1) ** 2 - 1
    rest = np.zeros((n, sh_len), dtype=np.float32)
    for i, name in enumerate(rest_names):
        rest[:, i] = np.asarray(v[name])
    # channel-major (3, K-1) -> [N, K-1, 3]
    features_rest = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)

    scale_names = sorted(
        (p for p in ply.vertex.properties if p.startswith("scale_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    scaling = np.stack([np.asarray(v[p]) for p in scale_names], axis=1).astype(np.float32)
    rot_names = sorted(
        (p for p in ply.vertex.properties if p.startswith("rot")),
        key=lambda s: int(s.split("_")[-1]),
    )
    rotation = np.stack([np.asarray(v[p]) for p in rot_names], axis=1).astype(np.float32)

    return {
        "xyz": xyz.astype(np.float32),
        "features_dc": f_dc,
        "features_rest": features_rest,
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
        "sh_degree": sh_degree,
    }


def gaussian_arrays_to_ply_columns(
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
) -> Dict[str, np.ndarray]:
    """GaussianCloud arrays -> ordered PLY columns.

    Field order matches `construct_list_of_attributes` + `save_ply`
    (`src/models/gaussian_model.py:155-185`): x, y, z, zero
    normals, f_dc (channel-major), f_rest (channel-major), opacity, scales,
    rots — all float32.
    """
    n = xyz.shape[0]
    cols: Dict[str, np.ndarray] = {}
    for i, name in enumerate(("x", "y", "z")):
        cols[name] = xyz[:, i].astype(np.float32)
    for name in ("nx", "ny", "nz"):
        cols[name] = np.zeros(n, dtype=np.float32)
    f_dc = features_dc.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
    f_rest = features_rest.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i].astype(np.float32)
    cols["opacity"] = opacity.reshape(n).astype(np.float32)
    for i in range(scaling.shape[1]):
        cols[f"scale_{i}"] = scaling[:, i].astype(np.float32)
    for i in range(rotation.shape[1]):
        cols[f"rot_{i}"] = rotation[:, i].astype(np.float32)
    return cols


def sparse_arrays_from_ply(ply: PlyData):
    """Sparse (SfM) PLY -> (xyz [N,3] f32, rgb [N,3] f32 in [0,1], normals or None).

    Mirrors `load_sparse_pc` + `convert_input_pc_to_open3d_pc`
    (`src/utils/file_loader.py:20-30`,
    `src/utils/point_cloud_converter.py:11-28`): colors are
    divided by 255.
    """
    v = ply.vertex.data
    xyz = np.stack([np.asarray(v["x"]), np.asarray(v["y"]), np.asarray(v["z"])], axis=1).astype(np.float32)
    rgb = np.stack(
        [np.asarray(v["red"]), np.asarray(v["green"]), np.asarray(v["blue"])], axis=1
    ).astype(np.float32) / 255.0
    normals: Optional[np.ndarray] = None
    if "nx" in ply.vertex.properties:
        normals = np.stack(
            [np.asarray(v["nx"]), np.asarray(v["ny"]), np.asarray(v["nz"])], axis=1
        ).astype(np.float32)
    return xyz, rgb, normals
