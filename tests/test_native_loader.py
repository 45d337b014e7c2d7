"""Native C++ loader tests: decode parity vs PIL, in-order prefetch, and the
numpy PGM reader that needs neither."""
import os

import numpy as np
import pytest
from PIL import Image

from uwslam_tpu.io import native


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        arr = rng.integers(0, 255, (32, 48), dtype=np.uint8)
        p = str(d / f"{i:04d}.png")
        Image.fromarray(arr).save(p)
        paths.append((p, arr))
    return paths


@pytest.fixture
def needs_native():
    """The library is built at first use; skip where that cannot happen."""
    if not native.available():
        pytest.skip("native loader unavailable (no g++ / libpng / libjpeg)")


@pytest.mark.usefixtures("needs_native")
class TestNativeDecode:
    def test_png_8bit_matches_pil(self, png_dir):
        for p, arr in png_dir:
            img = native.decode(p)
            np.testing.assert_allclose(img, arr.astype(np.float32))

    def test_png_16bit(self, tmp_path):
        arr = (np.arange(32 * 24, dtype=np.uint16) * 7 % 50000).reshape(24, 32)
        p = str(tmp_path / "d.png")
        Image.fromarray(arr, mode="I;16").save(p)
        img = native.decode(p)
        np.testing.assert_allclose(img, arr.astype(np.float32))

    def test_pgm(self, tmp_path):
        arr = np.arange(16 * 8, dtype=np.uint8).reshape(8, 16)
        p = str(tmp_path / "x.pgm")
        with open(p, "wb") as f:
            f.write(b"P5\n16 8\n255\n")
            f.write(arr.tobytes())
        img = native.decode(p)
        np.testing.assert_allclose(img, arr.astype(np.float32))

    def test_jpeg_close(self, tmp_path):
        arr = np.full((40, 40), 128, np.uint8)
        p = str(tmp_path / "x.jpg")
        Image.fromarray(arr).save(p, quality=95)
        img = native.decode(p)
        assert abs(float(img.mean()) - 128.0) < 3.0

    def test_missing_file(self):
        with pytest.raises(IOError):
            native.decode("/nonexistent/file.png")


@pytest.mark.usefixtures("needs_native")
class TestNativeLoader:
    def test_in_order_iteration(self, png_dir):
        paths = [p for p, _ in png_dir]
        loader = native.NativeLoader(paths, lookahead=3, threads=2)
        seen = []
        for idx, img in loader:
            seen.append(idx)
            np.testing.assert_allclose(img, png_dir[idx][1].astype(np.float32))
        loader.close()
        assert seen == list(range(len(paths)))

    def test_multiple_threads(self, png_dir):
        paths = [p for p, _ in png_dir] * 4
        loader = native.NativeLoader(paths, lookahead=8, threads=4)
        count = sum(1 for _ in loader)
        loader.close()
        assert count == len(paths)


class TestPgmReader:
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_roundtrip(self, tmp_path, dtype):
        from uwslam_tpu.io import read_pgm, write_pgm

        top = np.iinfo(dtype).max
        arr = (np.arange(24 * 37, dtype=np.int64) * 977 % (top + 1)).astype(
            dtype
        ).reshape(24, 37)
        p = str(tmp_path / "x.pgm")
        write_pgm(p, arr)
        img = read_pgm(p)
        assert img.dtype == np.float32 and img.shape == (24, 37)
        np.testing.assert_array_equal(img, arr.astype(np.float32))

    def test_ascii_header_comment_and_16bit_byte_order(self, tmp_path):
        from uwslam_tpu.io import read_pgm

        p = tmp_path / "c.pgm"
        p.write_bytes(b"P5\n# made by hand\n2 1\n65535\n\x01\x02\xff\x00")
        np.testing.assert_array_equal(read_pgm(str(p)), [[258.0, 65280.0]])
        q = tmp_path / "a.pgm"
        q.write_bytes(b"P2\n3 1\n255\n0 7 255\n")
        np.testing.assert_array_equal(read_pgm(str(q)), [[0.0, 7.0, 255.0]])

    def test_dataset_decodes_pgm_without_native_or_pillow(
        self, tmp_path, monkeypatch
    ):
        import builtins

        from uwslam_tpu.io import dataset, write_pgm

        arr = np.arange(6 * 5, dtype=np.uint8).reshape(6, 5)
        write_pgm(str(tmp_path / "f.pgm"), arr)
        monkeypatch.setattr(native, "available", lambda: False)
        real_import = builtins.__import__

        def no_pil(name, *a, **k):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError("no Pillow")
            return real_import(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_pil)
        np.testing.assert_array_equal(
            dataset._decode_image(str(tmp_path / "f.pgm")), arr
        )
        with pytest.raises(RuntimeError, match="native loader.*Pillow"):
            dataset._decode_image(str(tmp_path / "f.png"))


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])
