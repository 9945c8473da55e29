"""The port's TFRecord codec and ``dfutil`` against the JAX package's.

- ``encode_example``, the record framing and ``masked_crc32c`` produce
  the same bytes in both packages (exact equality) on seeded examples:
  floats (specials included), int64 (negatives, 2^62 scale), bytes
  (zero-length included), empty lists, and hypothesis-drawn feature
  dicts.
- Each package reads the files the other wrote, on both codecs.
- The port's native codec builds into the port's ``_build/`` (never the
  JAX package's ``_libtfrecord.so``) and agrees with its Python codec
  record by record, corruption and truncation included; ``codec_reads``
  says which codec each read used.
- ``dfutil``: the port's round trip, and its ``part-*`` files byte-equal
  to the reference's for the same DataFrame.
- ``Context.createDataFrame``: the schemas (row dicts, names only, tuples
  with a schema, and the dtype vocabulary) equal the reference's.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tensorflowonspark_tpu import tfrecord as jtfrecord
from tensorflowonspark_tpu.engine import dataframe as jdataframe
from tensorflowonspark_tpu_torch import _tfrecord_native, tfrecord
from tensorflowonspark_tpu_torch.engine import dataframe


def _seeded_examples(n=120, seed=1234):
    """Random feature dicts: empty lists, zero-length bytes, negative and
    64-bit ints, float specials, several features each."""
    rng = np.random.RandomState(seed)

    def value(kind):
        k = int(rng.randint(0, 6))
        if kind == 0:
            return [bytes(rng.randint(0, 256, size=rng.randint(0, 32),
                                      dtype=np.uint8).tobytes())
                    for _ in range(k)]
        if kind == 1:
            pool = [0.0, -0.0, 1.5e38, -1.5e-38, 3.25, -7.0, float("inf")]
            return [float(pool[rng.randint(len(pool))]) for _ in range(k)]
        pool = [0, 1, -1, 2 ** 31, -(2 ** 31), 2 ** 62, -(2 ** 62), 255]
        return [int(pool[rng.randint(len(pool))]) for _ in range(k)]

    out = []
    for _ in range(n):
        out.append({"f%d_%d" % (j, rng.randint(3)): value(int(rng.randint(3)))
                    for j in range(int(rng.randint(0, 8)))})
    out.append({"scalar_int": 7, "scalar_float": 0.5, "text": "héllo",
                "arr": np.arange(5, dtype=np.int64),
                "farr": np.linspace(-1, 1, 4).astype(np.float32)})
    return out


def test_encode_example_bytes_identical():
    for ex in _seeded_examples():
        assert tfrecord.encode_example(ex) == jtfrecord.encode_example(ex)


feature_values = st.one_of(
    st.lists(st.integers(-(2 ** 63), 2 ** 63 - 1), max_size=6),
    st.lists(st.floats(width=32, allow_nan=False), max_size=6),
    st.lists(st.binary(max_size=12), max_size=4))


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text("abcxyz_", min_size=1, max_size=6),
                       feature_values, max_size=5))
def test_encode_example_bytes_identical_hypothesis(features):
    data = tfrecord.encode_example(features)
    assert data == jtfrecord.encode_example(features)
    assert tfrecord.parse_example(data) == jtfrecord.parse_example(data)


def test_masked_crc32c_and_framing_identical(tmp_path):
    for blob in (b"", b"a", bytes(range(256)) * 3, b"x" * 999, b"\x00" * 64):
        assert tfrecord.masked_crc32c(blob) == jtfrecord.masked_crc32c(blob)
        assert _tfrecord_native.masked_crc32c(blob) == \
            jtfrecord.masked_crc32c(blob)
    examples = _seeded_examples(40)
    ours, theirs = str(tmp_path / "port.tfr"), str(tmp_path / "jax.tfr")
    assert tfrecord.write_tfrecords(ours, examples) == len(examples)
    jtfrecord.write_tfrecords(theirs, examples)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_each_package_reads_the_others_files(tmp_path, monkeypatch, native):
    examples = _seeded_examples(60, seed=7)
    ours, theirs = str(tmp_path / "port.tfr"), str(tmp_path / "jax.tfr")
    tfrecord.write_tfrecords(ours, examples)
    jtfrecord.write_tfrecords(theirs, examples)
    monkeypatch.setattr(tfrecord, "_NATIVE", native)
    monkeypatch.setattr(jtfrecord, "_NATIVE", native)
    got = [tfrecord.parse_example(r)
           for r in tfrecord.tfrecord_iterator(theirs)]
    want = [jtfrecord.parse_example(r)
            for r in jtfrecord.tfrecord_iterator(ours)]
    assert len(got) == len(want) == len(examples)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for name in a:
            assert a[name][0] == b[name][0]
            np.testing.assert_array_equal(np.asarray(a[name][1]),
                                          np.asarray(b[name][1]))
    assert tfrecord.count_records(theirs) == len(examples)


def test_native_codec_builds_into_the_ports_build_dir():
    assert _tfrecord_native.available()
    path = _tfrecord_native.library_path()
    assert os.path.dirname(path) == _tfrecord_native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.isfile(path)
    pkg = os.path.dirname(os.path.abspath(tfrecord.__file__))
    assert os.path.commonpath([path, pkg]) == pkg
    assert "_libtfrecord" not in path
    # the library's name carries a hash of the source: same source,
    # same name; a rebuild lands in the same place
    assert _tfrecord_native.library_path() == path


def test_native_and_python_codecs_agree(tmp_path, monkeypatch):
    path = str(tmp_path / "x.tfr")
    examples = _seeded_examples(80, seed=3)
    tfrecord.write_tfrecords(path, examples)
    before = dict(tfrecord.codec_reads)
    monkeypatch.setattr(tfrecord, "_NATIVE", True)
    native = list(tfrecord.tfrecord_iterator(path))
    assert tfrecord.codec_reads["native"] == before["native"] + 1
    monkeypatch.setattr(tfrecord, "_NATIVE", False)
    pure = list(tfrecord.tfrecord_iterator(path))
    assert tfrecord.codec_reads["python"] == before["python"] + 1
    assert native == pure and len(native) == len(examples)
    assert all(type(r) is bytes for r in native)


def test_native_corruption_and_truncation_match_python(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "x.tfr")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"payload-bytes")
    raw = open(path, "rb").read()
    cases = []
    bad = bytearray(raw)
    bad[14] ^= 0xFF  # a payload byte: the data crc fails
    cases.append((bytes(bad), "crc"))
    bad = bytearray(raw)
    bad[9] ^= 0xFF  # the length crc itself
    cases.append((bytes(bad), "crc"))
    cases.append((raw[:-2], "[Tt]runcat"))  # the trailing crc cut
    cases.append((raw[:6], "[Tt]runcat"))  # inside the length header
    for blob, match in cases:
        open(path, "wb").write(blob)
        for native in (True, False):
            monkeypatch.setattr(tfrecord, "_NATIVE", native)
            with pytest.raises(ValueError, match=match):
                list(tfrecord.tfrecord_iterator(path))


def test_read_batch_native_python_and_reference_agree(tmp_path,
                                                     monkeypatch):
    path = str(tmp_path / "dense.tfr")
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 50257, (24, 33)).astype(np.int64)
    with tfrecord.TFRecordWriter(path) as w:
        for i, r in enumerate(rows):
            w.write(tfrecord.encode_example(
                {"tokens": r, "w": [float(i), -0.5]}))
    schema = {"tokens": ("int64", 33), "w": ("float32", 2)}
    monkeypatch.setattr(tfrecord, "_NATIVE", True)
    native = tfrecord.read_batch(path, schema)
    monkeypatch.setattr(tfrecord, "_NATIVE", False)
    pure = tfrecord.read_batch(path, schema)
    want = jtfrecord.read_batch(path, schema)
    for name in schema:
        np.testing.assert_array_equal(native[name], pure[name])
        np.testing.assert_array_equal(native[name], want[name])
    np.testing.assert_array_equal(native["tokens"], rows)
    for use_native in (True, False):
        monkeypatch.setattr(tfrecord, "_NATIVE", use_native)
        with pytest.raises(ValueError, match="feature"):
            tfrecord.read_batch(path, {"tokens": ("int64", 34)})


def test_list_tfrecord_files_and_first_record(tmp_path):
    d = tmp_path / "recs"
    d.mkdir()
    for name in ("part-00001", "part-00000", "part-00000.crc", "_SUCCESS"):
        (d / name).write_bytes(b"")
    tfrecord.write_tfrecords(str(d / "part-00002"), [{"a": [1]}, {"a": [2]}])
    got = tfrecord.list_tfrecord_files(str(d))
    assert got == jtfrecord.list_tfrecord_files(str(d))
    assert [os.path.basename(p) for p in got] == [
        "part-00000", "part-00001", "part-00002"]
    assert tfrecord.first_record(got[0]) is None
    assert tfrecord.parse_example(tfrecord.first_record(got[2])) == \
        {"a": ("int64", [1])}
    from tensorflowonspark_tpu_torch import fs
    with pytest.raises(fs.UnsupportedSchemeError):
        tfrecord.list_tfrecord_files("hdfs://nn/recs")


# -- the DataFrame and dfutil ------------------------------------------------

ROWS = [{"label": i % 10, "weight": float(i) / 4.0, "text": "row-%d" % i,
         "vec": [float(i), float(i + 1)], "blob": b"\x00\x01" * (i % 3),
         "toks": ["a", "b-%d" % i], "ids": np.arange(i, i + 4)}
        for i in range(12)]


@pytest.mark.parametrize("form", ["dicts", "names", "tuples", "typed"])
def test_create_dataframe_schema_matches_reference(form):
    class _Ctx(object):
        def parallelize(self, data, num_slices=None):
            return list(data)

    names = sorted(ROWS[0])
    if form == "dicts":
        args = (ROWS, None)
    elif form == "names":
        args = (ROWS, names)
    elif form == "tuples":
        args = ([tuple(r[n] for n in names) for r in ROWS], names)
    else:
        args = ([tuple(r[n] for n in names) for r in ROWS],
                [(n, jdataframe._infer_dtype(ROWS[0][n])) for n in names])
    got = dataframe.create_dataframe(_Ctx(), *args)
    want = jdataframe.create_dataframe(_Ctx(), *args)
    assert got.schema == want.schema
    assert got.rdd == want.rdd
    assert dataframe.DTYPES == jdataframe.DTYPES
    with pytest.raises(ValueError, match="empty"):
        dataframe.create_dataframe(_Ctx(), [])


@pytest.fixture(scope="module")
def sc(tmp_path_factory):
    from tensorflowonspark_tpu_torch.engine import Context

    ctx = Context(num_executors=2,
                  work_root=str(tmp_path_factory.mktemp("eng")))
    yield ctx
    ctx.stop()


def test_dfutil_roundtrip_and_reference_bytes(sc, tmp_path):
    from tensorflowonspark_tpu import dfutil as jdfutil
    from tensorflowonspark_tpu_torch import dfutil

    df = sc.createDataFrame(ROWS, num_slices=3)
    assert df.getNumPartitions() == 3
    assert df.schema == jdataframe.infer_schema_from_row(ROWS[0])
    out = str(tmp_path / "recs")
    assert dfutil.saveAsTFRecords(df, out) == len(ROWS)
    files = tfrecord.list_tfrecord_files(out)
    assert [os.path.basename(f) for f in files] == [
        "part-00000", "part-00001", "part-00002"]
    # the same rows through the reference's converter, partition by
    # partition: the same bytes
    conv = jdfutil.toTFExample(df.schema)
    start = 0
    for path, n in zip(files, (4, 4, 4)):
        want = list(conv(iter(ROWS[start:start + n])))
        start += n
        assert list(tfrecord.tfrecord_iterator(path)) == want
    with pytest.raises(FileExistsError):
        dfutil.saveAsTFRecords(df, out)

    back = dfutil.loadTFRecords(sc, out, binary_features=("blob",))
    assert back.schema == jdfutil.infer_schema(
        tfrecord.first_record(files[0]), ("blob",))
    got = sorted(back.collect(), key=lambda r: r["weight"])
    assert len(got) == len(ROWS)
    for g, w in zip(got, ROWS):
        assert g["label"] == w["label"] and g["text"] == w["text"]
        assert abs(g["weight"] - w["weight"]) < 1e-6
        assert np.allclose(g["vec"], w["vec"])
        assert g["toks"] == w["toks"]
        assert g["ids"] == list(w["ids"])


def test_dataframe_operations(sc):
    df = sc.createDataFrame([{"a": i, "b": float(i)} for i in range(10)],
                            num_slices=2)
    assert df.count() == 10 and df.columns == ["a", "b"]
    sel = df.select("a").filter(lambda r: r["a"] % 2 == 0)
    assert [r["a"] for r in sel.collect()] == [0, 2, 4, 6, 8]
    wc = df.withColumn("c", lambda r: r["a"] * 2, "int64")
    assert wc.dtype_of("c") == "int64" and wc.collect()[3]["c"] == 6
    assert df.drop("b").columns == ["a"]
    with pytest.raises(ValueError):
        df.drop("a", "b")
    with pytest.raises(KeyError):
        df.select("zz")
