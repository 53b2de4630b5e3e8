"""Binary FBX loader: round-trip against a programmatically written file
(no FBX assets ship with the reference; the writer below emits the same
record structure Assimp/Blender produce, including a zlib-compressed
array and a quad needing triangulation)."""

import struct
import zlib

import numpy as np
import pytest

from rfw_tpu.scene import load_object
from rfw_tpu.scene.materials import MaterialList


def _prop(t, v):
    if t == "I":
        return b"I" + struct.pack("<i", v)
    if t == "L":
        return b"L" + struct.pack("<q", v)
    if t == "D":
        return b"D" + struct.pack("<d", v)
    if t == "S":
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if t == "d":   # f64 array, zlib-compressed
        raw = np.asarray(v, "<f8").tobytes()
        comp = zlib.compress(raw)
        return (b"d" + struct.pack("<III", len(v), 1, len(comp)) + comp)
    if t == "i":   # i32 array, uncompressed
        raw = np.asarray(v, "<i4").tobytes()
        return b"i" + struct.pack("<III", len(v), 0, len(raw)) + raw
    raise AssertionError(t)


def _node(name, props=b"", n_props=0, children=b""):
    nb = name.encode()
    null = b"\x00" * 13
    body = nb + props + children + (null if children else b"")
    # endOffset filled after sizing
    hdr_len = 12 + 1
    end_placeholder = hdr_len + len(body)
    return ("REL", end_placeholder, n_props, len(props), nb, props,
            children, bool(children))


def _emit(nodes, base):
    out = b""
    pos = base
    for (_tag, _rel, n_props, plen, nb, props, children, has_c) in nodes:
        # recompute: header(13) + name + props + children(+null)
        inner = len(nb) + plen
        child_bytes = children
        total = 13 + inner + len(child_bytes) + (13 if has_c else 0)
        end = pos + total
        out += struct.pack("<III", end, n_props, plen)
        out += bytes([len(nb)]) + nb + props + child_bytes
        if has_c:
            out += b"\x00" * 13
        pos = end
    return out


def _write_fbx(path):
    # unit quad (0..1 in xz at y=0) as ONE 4-gon + per-PV normals
    verts = [0, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1]
    pvi = [0, 1, 2, -4]                       # quad, last index = -(3+1)
    normals = [0, 1, 0] * 4
    uvs = [0, 0, 1, 0, 1, 1, 0, 1]
    uvidx = [0, 1, 2, 3]

    def leaf(name, props_list):
        props = b"".join(_prop(t, v) for t, v in props_list)
        return _emit([_node(name, props, len(props_list), b"")], 0), \
            ("defer", name)

    def raw_node(name, props_list, children=b""):
        props = b"".join(_prop(t, v) for t, v in props_list)
        n = _node(name, props, len(props_list), children)
        return n

    # children must be emitted with absolute offsets — build bottom-up
    def emit_tree(name, props_list, children_nodes, base):
        props = b"".join(_prop(t, v) for t, v in props_list)
        header = 13 + len(name)
        # first pass to size children
        child_base = base + header + len(props)
        child_bytes = b""
        cb = child_base
        for (cname, cprops, cchildren) in children_nodes:
            piece = emit_tree(cname, cprops, cchildren, cb)
            child_bytes += piece
            cb += len(piece)
        total = header + len(props) + len(child_bytes) + (
            13 if children_nodes else 0)
        end = base + total
        out = struct.pack("<III", end, len(props_list), len(props))
        out += bytes([len(name)]) + name.encode() + props + child_bytes
        if children_nodes:
            out += b"\x00" * 13
        return out

    geometry = ("Geometry", [("L", 100), ("S", "geo"), ("S", "Mesh")], [
        ("Vertices", [("d", verts)], []),
        ("PolygonVertexIndex", [("i", pvi)], []),
        ("LayerElementNormal", [("I", 0)], [
            ("MappingInformationType", [("S", "ByPolygonVertex")], []),
            ("ReferenceInformationType", [("S", "Direct")], []),
            ("Normals", [("d", normals)], []),
        ]),
        ("LayerElementUV", [("I", 0)], [
            ("MappingInformationType", [("S", "ByPolygonVertex")], []),
            ("ReferenceInformationType", [("S", "IndexToDirect")], []),
            ("UV", [("d", uvs)], []),
            ("UVIndex", [("i", uvidx)], []),
        ]),
    ])
    model = ("Model", [("L", 200), ("S", "quad"), ("S", "Mesh")], [
        ("Properties70", [], [
            ("P", [("S", "Lcl Translation"), ("S", ""), ("S", ""),
                   ("S", ""), ("D", 2.0), ("D", 0.0), ("D", 0.0)], []),
        ]),
    ])
    material = ("Material", [("L", 300), ("S", "red"), ("S", "")], [
        ("Properties70", [], [
            ("P", [("S", "DiffuseColor"), ("S", ""), ("S", ""),
                   ("S", ""), ("D", 0.8), ("D", 0.1), ("D", 0.1)], []),
        ]),
    ])
    conns = ("Connections", [], [
        ("C", [("S", "OO"), ("L", 100), ("L", 200)], []),
        ("C", [("S", "OO"), ("L", 300), ("L", 200)], []),
    ])

    header = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    body = b""
    pos = len(header)
    for name, props, children in [
            ("Objects", [], [geometry, model, material]), conns]:
        piece = emit_tree(name, props, children, pos)
        body += piece
        pos += len(piece)
    with open(path, "wb") as f:
        f.write(header + body + b"\x00" * 13)


def test_fbx_round_trip(tmp_path):
    p = tmp_path / "quad.fbx"
    _write_fbx(str(p))
    ml = MaterialList()
    obj = load_object(str(p), ml)
    assert len(obj.meshes) == 1
    m = obj.meshes[0]
    tris = m.triangles()
    assert tris.count == 2                      # quad fan-triangulated
    # model transform applied: translated +2 in x
    v = tris.vertices.reshape(-1, 3)
    assert v[:, 0].min() >= 2.0 - 1e-5 and v[:, 0].max() <= 3.0 + 1e-5
    # normals +y, uvs in [0,1]
    assert np.allclose(tris.normals.reshape(-1, 3)[:, 1], 1.0, atol=1e-5)
    assert tris.uv.min() >= -1e-6 and tris.uv.max() <= 1.0 + 1e-6
    # material color came through
    mat_id = int(np.asarray(tris.material).ravel()[0])
    assert np.allclose(ml.materials[mat_id].color,
                       [0.8, 0.1, 0.1], atol=1e-5)


def test_fbx_rejects_garbage(tmp_path):
    p = tmp_path / "bad.fbx"
    p.write_bytes(b"not an fbx file at all")
    with pytest.raises(ValueError, match="FBX"):
        load_object(str(p), MaterialList())


_ASCII_FBX = """; FBX 7.3.0 project file
FBXHeaderExtension:  {
\tFBXHeaderVersion: 1003
\tFBXVersion: 7300
}
Objects:  {
\tGeometry: 100, "Geometry::quad", "Mesh" {
\t\tVertices: *12 {
\t\t\ta: 0,0,0,1,0,0,1,0,1,0,0,1
\t\t}
\t\tPolygonVertexIndex: *4 {
\t\t\ta: 0,1,2,-4
\t\t}
\t\tLayerElementNormal: 0 {
\t\t\tVersion: 101
\t\t\tMappingInformationType: "ByPolygonVertex"
\t\t\tReferenceInformationType: "Direct"
\t\t\tNormals: *12 {
\t\t\t\ta: 0,1,0,0,1,0,0,1,0,
\t\t\t\t0,1,0
\t\t\t}
\t\t}
\t}
\tModel: 200, "Model::quad", "Mesh" {
\t\tVersion: 232
\t\tProperties70:  {
\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A",2,0,0
\t\t}
\t}
\tMaterial: 300, "Material::red", "" {
\t\tProperties70:  {
\t\t\tP: "DiffuseColor", "Color", "", "A",0.8,0.1,0.1
\t\t}
\t}
}
Connections:  {
\tC: "OO",100,200
\tC: "OO",300,200
}
"""


def test_fbx_ascii_round_trip(tmp_path):
    """ASCII FBX (the Assimp-breadth item): same
    scene content as the binary round trip, text encoding."""
    p = tmp_path / "quad_ascii.fbx"
    p.write_text(_ASCII_FBX)
    ml = MaterialList()
    obj = load_object(str(p), ml)
    assert len(obj.meshes) == 1
    tris = obj.meshes[0].triangles()
    assert tris.count == 2                      # quad fan-triangulated
    v = tris.vertices.reshape(-1, 3)
    assert v[:, 0].min() >= 2.0 - 1e-5 and v[:, 0].max() <= 3.0 + 1e-5
    assert np.allclose(tris.normals.reshape(-1, 3)[:, 1], 1.0, atol=1e-5)
    mat_id = int(np.asarray(tris.material).ravel()[0])
    assert np.allclose(ml.materials[mat_id].color,
                       [0.8, 0.1, 0.1], atol=1e-5)
