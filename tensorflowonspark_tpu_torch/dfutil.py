"""DataFrame ⇄ TFRecord conversion utilities — the port's copy of
``tensorflowonspark_tpu/dfutil.py``, on the port's engine.

Reference: ``tensorflowonspark/dfutil.py`` (SURVEY.md §2 "TFRecord
interop"): ``saveAsTFRecords`` / ``loadTFRecords`` / ``infer_schema`` /
``toTFExample`` / ``fromTFExample``. The reference delegated the file
format to the third-party tensorflow-hadoop JAR; here the codec is
first-party (:mod:`tensorflowonspark_tpu_torch.tfrecord`) and the files are
written/read directly by executor tasks in the Hadoop ``part-*`` layout.

Nothing is left out: every function of the reference is here.
"""

import os

from tensorflowonspark_tpu_torch import tfrecord
from tensorflowonspark_tpu_torch.engine.dataframe import DataFrame


def toTFExample(schema):
    """Returns rows -> serialized Example bytes iterator transform.

    Reference: ``dfutil.toTFExample(dtypes)`` used per-partition via
    ``df.rdd.mapPartitions``.
    """
    schema = list(schema)

    def _convert(iterator):
        for row in iterator:
            features = {}
            for name, dtype in schema:
                v = row[name]
                if dtype == "string":
                    v = [v.encode("utf-8") if isinstance(v, str) else bytes(v)]
                elif dtype == "binary":
                    v = [bytes(v)]
                elif dtype == "int64":
                    v = [int(v)]
                elif dtype == "float32":
                    v = [float(v)]
                elif dtype.startswith("array<"):
                    inner = dtype[6:-1]
                    if inner == "int64":
                        v = [int(x) for x in v]
                    elif inner == "float32":
                        v = [float(x) for x in v]
                    else:  # array<string> / array<binary>
                        v = [x.encode("utf-8") if isinstance(x, str)
                             else bytes(x) for x in v]
                else:
                    raise TypeError("unsupported dtype {}".format(dtype))
                features[name] = v
            yield tfrecord.encode_example(features)

    return _convert


def fromTFExample(schema=None, binary_features=()):
    """Returns serialized-Example -> row-dict iterator transform.

    Reference: ``dfutil.fromTFExample``. ``binary_features`` lists
    bytes_list columns to keep as raw bytes (others decode utf-8, matching
    the reference's string-by-default behavior).
    """
    binary = set(binary_features)
    schema = list(schema) if schema else None
    smap = dict(schema) if schema else None

    def _convert(iterator):
        for data in iterator:
            parsed = tfrecord.parse_example(bytes(data))
            row = {}
            for name, (kind, values) in parsed.items():
                if kind == "bytes":
                    if name not in binary and (smap is None or
                                               "binary" not in
                                               smap.get(name, "")):
                        values = [v.decode("utf-8") for v in values]
                elif kind == "float":
                    values = [float(v) for v in values]
                elif kind == "int64":
                    values = [int(v) for v in values]
                if smap is not None:
                    dtype = smap.get(name, "")
                    if dtype.startswith("array<"):
                        row[name] = values
                    else:
                        if len(values) > 1:
                            raise ValueError(
                                "feature {!r} inferred as scalar {} but a "
                                "record holds {} values — variable-length "
                                "features need an array<> dtype (pass an "
                                "explicit schema)".format(
                                    name, dtype, len(values)))
                        row[name] = values[0] if values else None
                else:
                    row[name] = values[0] if len(values) == 1 else values
            if smap is not None:
                # Example features are optional per record: keep rows
                # rectangular so select()/re-save never KeyError.
                for cname, cdtype in smap.items():
                    if cname not in row:
                        row[cname] = [] if cdtype.startswith("array<") \
                            else None
            yield row

    return _convert


def infer_schema(example_bytes, binary_features=()):
    """First serialized Example -> [(name, dtype)] (sorted).

    Reference: ``dfutil.infer_schema`` on the first record. Multi-value
    features map to array<> dtypes; single-value to scalars (so fixed-size
    vectors round-trip as arrays).
    """
    parsed = tfrecord.parse_example(bytes(example_bytes))
    schema = []
    for name in sorted(parsed):
        kind, values = parsed[name]
        if kind == "bytes":
            base = "binary" if name in binary_features else "string"
        elif kind == "float":
            base = "float32"
        elif kind == "int64":
            base = "int64"
        else:
            base = "float32"
        if len(values) > 1:
            base = "array<{}>".format(base)
        schema.append((name, base))
    return schema


def saveAsTFRecords(df, output_dir):
    """Write a DataFrame as ``part-NNNNN`` TFRecord files.

    Reference: ``dfutil.saveAsTFRecords(df, output_dir)`` (which went
    through ``saveAsNewAPIHadoopFile``). Fails if output_dir exists, like
    Hadoop output committers do.
    """
    from tensorflowonspark_tpu_torch import fs

    output_dir = fs.require_local(output_dir, "saveAsTFRecords")
    os.makedirs(output_dir, exist_ok=False)
    schema = df.schema
    serialized = df.rdd.mapPartitions(toTFExample(schema))

    def _write(index, iterator):
        path = os.path.join(output_dir, "part-%05d" % index)
        with tfrecord.TFRecordWriter(path) as w:
            count = 0
            for record in iterator:
                w.write(record)
                count += 1
        yield count

    return sum(serialized.mapPartitionsWithIndex(_write).collect())


def loadTFRecords(sc, input_dir, binary_features=(), num_partitions=None):
    """Load a TFRecord directory as a DataFrame.

    Reference: ``dfutil.loadTFRecords`` — reads the first record to infer
    the schema, then parses every file. One partition per part file by
    default (the Hadoop-split analog).
    """
    files = tfrecord.list_tfrecord_files(input_dir)
    if not files:
        raise FileNotFoundError("no part-* TFRecord files in " + input_dir)
    # Hadoop committers routinely write empty part files for empty
    # partitions: infer from the first file that actually has a record.
    first = None
    for path in files:
        # first_record: lazy single-record read — the native iterator
        # would CRC-scan the entire shard just to infer the schema
        first = tfrecord.first_record(path)
        if first is not None:
            break
    if first is None:
        raise ValueError("all part-* files in {} are empty".format(input_dir))
    schema = infer_schema(first, binary_features)

    file_rdd = sc.parallelize(files, num_partitions or len(files))
    conv = fromTFExample(schema, binary_features)

    def _read(iterator):
        for path in iterator:
            for row in conv(tfrecord.tfrecord_iterator(path)):
                yield row

    return DataFrame(file_rdd.mapPartitions(_read), schema)
