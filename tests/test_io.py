"""I/O format behavior (parity with crates/io/src/{pcd,ply,las}.rs)."""

import os

import numpy as np
import pytest

import pointclouds_jax as pc
from pointclouds_jax.io import las as las_io

REF_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


def test_read_reference_pcd_files():
    bunny = pc.read_pcd(os.path.join(REF_DATA, "bunny.pcd"))
    assert bunny.len() == 1
    np.testing.assert_allclose(bunny.to_numpy(), [[0, 0, 0]])
    scans = pc.read_pcd(os.path.join(REF_DATA, "two_scans.pcd"))
    assert scans.len() == 2
    plane = pc.read_pcd(os.path.join(REF_DATA, "plane_with_noise.pcd"))
    assert plane.len() == 3


def test_pcd_ascii_roundtrip(tmp_path):
    data = np.array([[1.5, -2.25, 3.125], [4, 5, 6]], dtype=np.float32)
    c = pc.PointCloud.from_numpy(data)
    path = str(tmp_path / "t.pcd")
    pc.write_pcd(path, c)
    back = pc.read_pcd(path)
    assert back.len() == 2
    np.testing.assert_array_equal(back.to_numpy(), data)  # exact decimals


def test_pcd_binary_roundtrip(tmp_path):
    data = np.random.rand(100, 3).astype(np.float32)
    path = str(tmp_path / "t.pcd")
    pc.write_pcd_binary(path, pc.PointCloud.from_numpy(data))
    back = pc.read_pcd(path)
    np.testing.assert_array_equal(back.to_numpy(), data)  # bit-exact


def test_pcd_read_errors(tmp_path):
    with pytest.raises((IOError, OSError)):
        pc.read_pcd(str(tmp_path / "missing.pcd"))
    bad = tmp_path / "bad.pcd"
    bad.write_text("not a pcd at all\n")
    with pytest.raises((IOError, OSError)):
        pc.read_pcd(str(bad))


def test_pcd_ascii_parse_error_becomes_zero(tmp_path):
    # ref pcd.rs:214-218: unparsable values -> 0.0
    path = tmp_path / "weird.pcd"
    path.write_text(
        "VERSION 0.7\nFIELDS x y z\nPOINTS 2\nDATA ascii\n"
        "1.0 abc 3.0\n4.0 5.0 6.0\n"
    )
    back = pc.read_pcd(str(path))
    np.testing.assert_allclose(back.to_numpy(), [[1, 0, 3], [4, 5, 6]])


def test_pcd_binary_extra_fields(tmp_path):
    # binary PCD with intensity field: x/y/z located by name
    import struct

    n = 2
    header = (
        "VERSION 0.7\nFIELDS intensity x y z\nSIZE 4 4 4 4\n"
        f"TYPE F F F F\nCOUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
        f"POINTS {n}\nDATA binary\n"
    )
    body = struct.pack("<8f", 9.0, 1.0, 2.0, 3.0, 8.0, 4.0, 5.0, 6.0)
    path = tmp_path / "i.pcd"
    path.write_bytes(header.encode() + body)
    back = pc.read_pcd(str(path))
    np.testing.assert_allclose(back.to_numpy(), [[1, 2, 3], [4, 5, 6]])


def test_pcd_truncated_binary_raises(tmp_path):
    header = (
        "VERSION 0.7\nFIELDS x y z\nPOINTS 10\nDATA binary\n"
    )
    path = tmp_path / "trunc.pcd"
    path.write_bytes(header.encode() + b"\x00" * 8)
    with pytest.raises((IOError, OSError)):
        pc.read_pcd(str(path))


def test_pcd_writer_drops_attributes(tmp_path):
    # write_pcd emits FIELDS x y z only (ref pcd.rs:23-42)
    c = pc.estimate_normals(
        pc.PointCloud.from_numpy(np.random.rand(10, 3).astype(np.float32)), 3
    )
    path = str(tmp_path / "n.pcd")
    pc.write_pcd(path, c)
    text = open(path).read()
    assert "FIELDS x y z\n" in text
    back = pc.read_pcd(path)
    assert back._normals_numpy() is None


# ── PLY ──────────────────────────────────────────────────────────────────────


def test_ply_ascii_roundtrip(tmp_path):
    data = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.float32)
    path = str(tmp_path / "t.ply")
    pc.write_ply(path, pc.PointCloud.from_numpy(data))
    back = pc.read_ply(path)
    assert back.len() == 2
    np.testing.assert_array_equal(back.to_numpy(), data)


def test_ply_binary_bit_exact(tmp_path):
    data = np.array([[1.5, 2.5, 3.5], [4.5, 5.5, 6.5]], dtype=np.float32)
    path = str(tmp_path / "b.ply")
    pc.write_ply_binary(path, pc.PointCloud.from_numpy(data))
    back = pc.read_ply(path)
    np.testing.assert_array_equal(back.to_numpy(), data)


def test_ply_preserves_normals_and_colors(tmp_path):
    data = np.random.rand(30, 3).astype(np.float32)
    c = pc.estimate_normals(pc.PointCloud.from_numpy(data), 5)
    for writer in (pc.write_ply, pc.write_ply_binary):
        path = str(tmp_path / f"{writer.__name__}.ply")
        writer(path, c)
        back = pc.read_ply(path)
        assert back._normals_numpy() is not None
        np.testing.assert_allclose(
            back._normals_numpy(), c._normals_numpy(), atol=1e-6
        )


def test_ply_double_properties_read_correctly(tmp_path):
    """Double-typed coordinates must be read as 8-byte doubles (the
    reference's 4-byte misread is a documented latent bug — SURVEY.md C19
    says do not replicate it)."""
    header = (
        "ply\nformat binary_little_endian 1.0\nelement vertex 2\n"
        "property double x\nproperty double y\nproperty double z\n"
        "end_header\n"
    )
    body = np.array(
        [[1.25, 2.5, 3.75], [-1.0, 0.5, 9.0]], dtype="<f8"
    ).tobytes()
    path = tmp_path / "d.ply"
    path.write_bytes(header.encode() + body)
    back = pc.read_ply(str(path))
    np.testing.assert_allclose(
        back.to_numpy(), [[1.25, 2.5, 3.75], [-1.0, 0.5, 9.0]]
    )


def test_ply_missing_xyz_raises(tmp_path):
    path = tmp_path / "nx.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 1\n"
        "property float a\nproperty float b\nproperty float c\n"
        "end_header\n1 2 3\n"
    )
    with pytest.raises((IOError, OSError)):
        pc.read_ply(str(path))


def test_ply_bad_magic_raises(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_text("noply\nend_header\n")
    with pytest.raises((IOError, OSError)):
        pc.read_ply(str(path))


def test_ply_colors_roundtrip(tmp_path):
    xyz = np.random.rand(5, 3).astype(np.float32)
    colors = np.random.randint(0, 256, (5, 3), dtype=np.uint8)
    from pointclouds_jax.io import ply as ply_io

    path = str(tmp_path / "c.ply")
    ply_io.write_ply_binary(path, xyz, colors=colors)
    x2, n2, c2 = ply_io.read_ply(path)
    np.testing.assert_array_equal(x2, xyz)
    assert n2 is None
    np.testing.assert_array_equal(c2, colors)


# ── LAS ──────────────────────────────────────────────────────────────────────


def test_las_missing_file_raises():
    with pytest.raises((IOError, OSError)):
        pc.read_las("/tmp/definitely_not_a_real_file_xyz_123.las")


def test_las_roundtrip(tmp_path):
    xyz = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], dtype=np.float64)
    path = str(tmp_path / "t.las")
    las_io.write_las(path, xyz, intensity=[100, 200])
    cloud = pc.read_las(path)
    assert cloud.len() == 2
    np.testing.assert_allclose(cloud.to_numpy(), xyz, atol=0.01)
    inten = cloud._intensity_numpy()
    assert inten is not None
    np.testing.assert_allclose(inten, [100.0, 200.0])


def test_las_zero_intensity_not_attached(tmp_path):
    # ref las.rs:28-36: intensity only attached if any nonzero
    xyz = np.array([[1.0, 2.0, 3.0]], dtype=np.float64)
    path = str(tmp_path / "z.las")
    las_io.write_las(path, xyz)
    cloud = pc.read_las(path)
    assert cloud._intensity_numpy() is None


def test_las_not_las_raises(tmp_path):
    path = tmp_path / "fake.las"
    path.write_bytes(b"NOTL" + b"\x00" * 300)
    with pytest.raises((IOError, OSError)):
        pc.read_las(str(path))
