"""Binary FBX 7.x loader → SceneObject (dependency-free).

Completes the Assimp-breadth surface (reference assimp/object.cpp:88-91 —
Assimp's "any format" net includes FBX). Scope: static geometry — meshes (polygons of any arity,
fan-triangulated), per-vertex/per-polygon-vertex normals and UVs (direct
and index-to-direct mappings), per-mesh Lambert/Phong material colors, and
node transforms (Lcl Translation/Rotation/Scaling with the standard FBX
T·R·S composition). Animation/skinning in FBX is out of scope — the
framework's animation path is glTF (SURVEY §2.3).

Format notes (public spec, widely documented): the file is a tree of
records [endOffset u32][numProps u32][propListLen u32][nameLen u8][name]
[properties...][children][13-byte null record]; properties are typed
(Y,C,I,L,F,D, arrays f,d,i,l with optional zlib deflate, S/R raw). FBX
≥ 7500 widens the record header fields to u64.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .materials import HostMaterial, MaterialList
from .mesh import SceneMesh
from .object import SceneObject

_MAGIC = b"Kaydara FBX Binary  \x00"


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children = []

    def find(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def findall(self, name):
        return [c for c in self.children if c.name == name]


def _read_props(data, pos, count):
    props = []
    for _ in range(count):
        t = data[pos:pos + 1]
        pos += 1
        if t == b"Y":
            props.append(struct.unpack_from("<h", data, pos)[0]); pos += 2
        elif t == b"C":
            props.append(bool(data[pos])); pos += 1
        elif t == b"I":
            props.append(struct.unpack_from("<i", data, pos)[0]); pos += 4
        elif t == b"L":
            props.append(struct.unpack_from("<q", data, pos)[0]); pos += 8
        elif t == b"F":
            props.append(struct.unpack_from("<f", data, pos)[0]); pos += 4
        elif t == b"D":
            props.append(struct.unpack_from("<d", data, pos)[0]); pos += 8
        elif t in (b"f", b"d", b"i", b"l", b"b"):
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            dt = {b"f": "<f4", b"d": "<f8", b"i": "<i4", b"l": "<i8",
                  b"b": "u1"}[t]
            if enc == 1:
                raw = zlib.decompress(data[pos:pos + clen])
                pos += clen
            else:
                size = n * np.dtype(dt).itemsize
                raw = data[pos:pos + size]
                pos += size
            props.append(np.frombuffer(raw, dtype=dt, count=n))
        elif t in (b"S", b"R"):
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            raw = data[pos:pos + n]
            pos += n
            props.append(raw.decode("utf-8", "replace") if t == b"S"
                         else raw)
        else:
            raise ValueError(f"malformed FBX: unknown property type {t!r}")
    return props, pos


def _parse(data: bytes):
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", data, 23)[0]
    wide = version >= 7500
    pos = 27
    root = _Node("", [])
    while pos < len(data):
        node, pos = _iter_node(data, pos, wide)
        if node is None:
            break
        root.children.append(node)
    return root, version


def _iter_node(data, pos, wide):
    """Read one node record (iterative recursion over children)."""
    if wide:
        if pos + 25 > len(data):
            return None, len(data)
        end, n_props, _plen = struct.unpack_from("<QQQ", data, pos)
        hdr = 24
    else:
        if pos + 13 > len(data):
            return None, len(data)
        end, n_props, _plen = struct.unpack_from("<III", data, pos)
        hdr = 12
    name_len = data[pos + hdr]
    if end == 0 and n_props == 0 and name_len == 0:
        return None, pos + hdr + 1
    p = pos + hdr + 1
    name = data[p:p + name_len].decode("ascii", "replace")
    p += name_len
    props, p = _read_props(data, p, n_props)
    node = _Node(name, props)
    while p < end:
        child, p = _iter_node(data, p, wide)
        if child is None:
            break
        node.children.append(child)
    return node, end


def _parse_ascii(text: str):
    """ASCII FBX → the same ``_Node`` tree the binary parser yields
    (reference parity: Assimp reads both encodings, assimp/object.cpp:
    88-91).

    Grammar (documented publicly): ``Name: p1, p2, ... {`` opens a
    block; ``Key: *N { a: v,v,... }`` is an array node whose ``a:``
    payload becomes the node's props[0] numpy array (matching the
    binary reader's layout); ``;`` starts a comment."""
    root = _Node("", [])
    stack = [root]
    pending_array: _Node | None = None
    buf: list[str] = []

    def parse_value(tok: str):
        tok = tok.strip()
        if not tok:
            return None
        if tok.startswith('"'):
            return tok.strip('"')
        if tok.startswith("*"):
            return tok          # array-length marker, replaced by payload
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                return tok       # bare word (Y/W/T flags etc.)

    def split_props(s: str):
        out, cur, inq = [], [], False
        for ch in s:
            if ch == '"':
                inq = not inq
                cur.append(ch)
            elif ch == "," and not inq:
                out.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        if cur and "".join(cur).strip():
            out.append("".join(cur))
        vals = [parse_value(t) for t in out]
        return [v for v in vals if v is not None]

    def flush_array():
        nonlocal pending_array, buf
        if pending_array is not None:
            nums = ",".join(buf).replace(",,", ",").strip(", \t")
            toks = [t for t in nums.split(",") if t.strip()]
            if toks and all("." not in t and "e" not in t.lower()
                            for t in toks):
                arr = np.array([int(t) for t in toks], np.int64)
            else:
                arr = np.array([float(t) for t in toks], np.float64)
            pending_array.props = [arr]
            pending_array = None
            buf = []

    for raw in text.splitlines():
        line = raw.split(";", 1)[0].strip() if '"' not in raw \
            else raw.strip()
        if not line:
            continue
        if pending_array is not None:
            if line.startswith("a:"):
                buf.append(line[2:])
                continue
            if line == "}":
                flush_array()
                continue
            if line.endswith(","):   # continuation of the a: payload
                buf.append(line)
                continue
            buf.append(line)
            continue
        if line == "}":
            if len(stack) > 1:
                stack.pop()
            continue
        if ":" not in line:
            continue
        name, rest = line.split(":", 1)
        name = name.strip()
        opens = rest.rstrip().endswith("{")
        if opens:
            rest = rest.rstrip()[:-1]
        props = split_props(rest)
        node = _Node(name, props)
        stack[-1].children.append(node)
        if opens:
            if props and isinstance(props[0], str) \
                    and props[0].startswith("*"):
                pending_array = node      # array block: capture a: payload
            else:
                stack.append(node)
    return root


def _layer_values(geom, layer_name, value_name, index_name, n_pv, pvi_map):
    """Resolve a LayerElement to per-polygon-vertex (N_pv, k) values."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    mapping = ""
    ref = ""
    vals = None
    idx = None
    for c in layer.children:
        if c.name == "MappingInformationType":
            mapping = c.props[0]
        elif c.name == "ReferenceInformationType":
            ref = c.props[0]
        elif c.name == value_name:
            vals = np.asarray(c.props[0], np.float64)
        elif c.name == index_name:
            idx = np.asarray(c.props[0], np.int64)
    if vals is None:
        return None
    k = 2 if value_name == "UV" else 3
    vals = vals.reshape(-1, k)
    if ref == "IndexToDirect" and idx is not None:
        vals = vals[np.clip(idx, 0, len(vals) - 1)]
    if mapping == "ByPolygonVertex":
        return vals[:n_pv]
    if mapping == "ByControlPoint":
        return vals[pvi_map]
    if mapping == "AllSame":
        return np.broadcast_to(vals[0], (n_pv, k))
    return None


def _rot_matrix(rx, ry, rz):
    cx, sx = np.cos(np.radians(rx)), np.sin(np.radians(rx))
    cy, sy = np.cos(np.radians(ry)), np.sin(np.radians(ry))
    cz, sz = np.cos(np.radians(rz)), np.sin(np.radians(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx                      # FBX default XYZ euler order


def load_fbx(path: str, materials: MaterialList,
             material_override: int = -1) -> SceneObject:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= 27 and data[:len(_MAGIC)] == _MAGIC:
        root, _version = _parse(data)
    else:
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError:
            raise ValueError(f"not an FBX file: {path}") from None
        if "FBXHeaderExtension" not in text[:4096]:
            raise ValueError(f"not an FBX file: {path}")
        root = _parse_ascii(text)

    objects = root.find("Objects")
    if objects is None:
        raise ValueError(f"malformed FBX (no Objects): {path}")

    # id → node tables + connections
    geoms = {}
    models = {}
    mats = {}
    for c in objects.children:
        if not c.props or not isinstance(c.props[0], int):
            continue
        oid = c.props[0]
        if c.name == "Geometry":
            geoms[oid] = c
        elif c.name == "Model":
            models[oid] = c
        elif c.name == "Material":
            mats[oid] = c
    conns = []
    cnode = root.find("Connections")
    if cnode is not None:
        for c in cnode.children:
            if c.name == "C" and len(c.props) >= 3:
                conns.append((c.props[1], c.props[2]))   # child → parent

    def model_transform(mid):
        m = models.get(mid)
        t = np.zeros(3)
        r = np.zeros(3)
        s = np.ones(3)
        if m is not None:
            p70 = m.find("Properties70")
            if p70 is not None:
                for p in p70.findall("P"):
                    if p.props[0] == "Lcl Translation":
                        t = np.array(p.props[4:7], np.float64)
                    elif p.props[0] == "Lcl Rotation":
                        r = np.array(p.props[4:7], np.float64)
                    elif p.props[0] == "Lcl Scaling":
                        s = np.array(p.props[4:7], np.float64)
        m4 = np.eye(4)
        m4[:3, :3] = _rot_matrix(*r) * s[None, :]
        m4[:3, 3] = t
        return m4

    def material_color(mid):
        mnode = mats.get(mid)
        color = np.array([0.7, 0.7, 0.7], np.float32)
        rough = 1.0
        if mnode is not None:
            p70 = mnode.find("Properties70")
            if p70 is not None:
                for p in p70.findall("P"):
                    if p.props[0] in ("DiffuseColor", "Diffuse"):
                        color = np.array(p.props[4:7], np.float32)
                    elif p.props[0] == "Shininess":
                        rough = float(np.clip(
                            np.sqrt(2.0 / (2.0 + p.props[4])), 0.03, 1.0))
        return materials.add(HostMaterial(name="fbx", color=color,
                                          roughness=rough))

    obj = SceneObject(name=path)
    for gid, geom in geoms.items():
        vnode = geom.find("Vertices")
        inode = geom.find("PolygonVertexIndex")
        if vnode is None or inode is None:
            continue
        verts = np.asarray(vnode.props[0], np.float64).reshape(-1, 3)
        pvi = np.asarray(inode.props[0], np.int64)
        # negative index = last vertex of the polygon, stored as -(i+1)
        poly_end = pvi < 0
        cp = np.where(poly_end, -pvi - 1, pvi)

        # fan-triangulate each polygon
        tris = []
        start = 0
        for end_i in np.flatnonzero(poly_end):
            m = end_i - start + 1
            for j in range(1, m - 1):
                tris.append((start, start + j, start + j + 1))
            start = end_i + 1
        if not tris:
            continue
        tri_pv = np.asarray(tris, np.int64)          # (T, 3) into pv order

        n_pv = len(cp)
        normals = _layer_values(geom, "LayerElementNormal", "Normals",
                                "NormalsIndex", n_pv, cp)
        uvs = _layer_values(geom, "LayerElementUV", "UV", "UVIndex",
                            n_pv, cp)

        # model transform + material via connections (geometry → model)
        xform = np.eye(4)
        mat_id = material_override
        for child, parent in conns:
            if child == gid and parent in models:
                xform = model_transform(parent)
                if material_override < 0:
                    for c2, p2 in conns:
                        if p2 == parent and c2 in mats:
                            mat_id = material_color(c2)
                            break
                break
        if mat_id < 0:
            mat_id = materials.add(HostMaterial(
                name="fbx", color=np.array([0.7, 0.7, 0.7], np.float32),
                roughness=1.0))

        # expand to unshared per-polygon-vertex mesh (normals/uvs are in
        # pv space; sharing would need weld passes — correctness first)
        pos_pv = verts[cp]
        pos_pv = pos_pv @ xform[:3, :3].T + xform[:3, 3]
        positions = pos_pv[tri_pv.reshape(-1)].astype(np.float32)
        indices = np.arange(len(positions), dtype=np.int32).reshape(-1, 3)
        nrm = (normals[tri_pv.reshape(-1)].astype(np.float32)
               if normals is not None else None)
        if nrm is not None:
            nmat = np.linalg.inv(xform[:3, :3]).T \
                if abs(np.linalg.det(xform[:3, :3])) > 1e-12 \
                else xform[:3, :3]
            nrm = nrm @ nmat.T
            nrm /= np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
        uv = (uvs[tri_pv.reshape(-1)].astype(np.float32)
              if uvs is not None else None)
        obj.meshes.append(SceneMesh(
            positions=positions, indices=indices, normals=nrm, uv=uv,
            material_ids=mat_id))

    if not obj.meshes:
        raise ValueError(f"FBX contains no geometry: {path}")
    obj.finalize()
    return obj
