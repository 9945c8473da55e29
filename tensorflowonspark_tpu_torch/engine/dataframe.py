"""Minimal Spark-shaped DataFrame: named, typed columns over an RDD of
rows — the port's copy of ``tensorflowonspark_tpu/engine/dataframe.py``.

The reference's pipeline/dfutil layers consume Spark DataFrames; pyspark
isn't in the image (SURVEY.md §7 environment note), so the engine carries
a small columnar shim with the same *shape*: a row RDD plus a schema, and
the handful of operations the framework layers exercise (``rdd``,
``select``, ``withColumn``, ``collect``, ``count``, ``columns``). Rows are
plain dicts — the pipeline's input_mapping/output_mapping address columns
by name exactly as the reference does.

Nothing is left out: every operation of the reference is here.
"""

import numpy as np


#: schema dtype vocabulary (mirrors the subset dfutil round-trips)
DTYPES = ("int64", "float32", "string", "binary",
          "array<int64>", "array<float32>", "array<string>", "array<binary>")


def _infer_dtype(value):
    if isinstance(value, (list, tuple, np.ndarray)):
        if len(value) == 0:
            return "array<float32>"
        inner = _infer_dtype(value[0])
        return "array<{}>".format(inner)
    if isinstance(value, (bool, int, np.integer)):
        return "int64"
    if isinstance(value, (float, np.floating)):
        return "float32"
    if isinstance(value, str):
        return "string"
    if isinstance(value, (bytes, bytearray)):
        return "binary"
    raise TypeError("cannot infer dtype for {!r}".format(type(value)))


def infer_schema_from_row(row):
    """{col: value} -> ordered [(name, dtype)] (sorted for determinism)."""
    return [(name, _infer_dtype(row[name])) for name in sorted(row)]


class DataFrame(object):
    """A row RDD + schema. Construct via ``Context.createDataFrame``.

    ``schema`` may be a ``[(name, dtype)]`` list or a zero-arg callable
    returning one — the callable is resolved on first access, so a
    producer whose dtypes are only knowable by computing data (e.g.
    ``TFModel.transform``) can stay lazy.
    """

    def __init__(self, rdd, schema):
        self.rdd = rdd
        self._schema = None if callable(schema) else list(schema)
        self._schema_fn = schema if callable(schema) else None

    @property
    def schema(self):
        if self._schema is None:
            self._schema = list(self._schema_fn())
        return self._schema

    @property
    def columns(self):
        return [name for name, _ in self.schema]

    def dtype_of(self, col):
        for name, dtype in self.schema:
            if name == col:
                return dtype
        raise KeyError(col)

    def select(self, *cols):
        cols = list(cols)
        schema = [(n, d) for n, d in self.schema if n in cols]
        missing = set(cols) - {n for n, _ in schema}
        if missing:
            raise KeyError("no such columns: {}".format(sorted(missing)))
        rdd = self.rdd.map(lambda row, _c=tuple(cols): {k: row[k] for k in _c})
        return DataFrame(rdd, schema)

    def withColumn(self, name, fn, dtype):
        """Add/replace a column computed per row by ``fn(row)``."""
        def add(row, _fn=fn, _n=name):
            out = dict(row)
            out[_n] = _fn(row)
            return out
        schema = [(n, d) for n, d in self.schema if n != name]
        schema.append((name, dtype))
        return DataFrame(self.rdd.map(add), schema)

    def filter(self, predicate):
        """Rows where ``predicate(row)`` is truthy; schema unchanged.

        ``predicate`` is a plain python fn over the row dict (the
        ``withColumn`` convention — no expression DSL exists here).
        """
        return DataFrame(self.rdd.filter(predicate), self.schema)

    #: Spark alias: ``where`` is ``filter``
    where = filter

    def drop(self, *cols):
        """Drop the named columns (unknown names ignored, like Spark).

        Dropping everything is refused — a zero-column DataFrame has no
        row representation here (rows are plain dicts).
        """
        cols = set(cols)
        keep = [n for n, _ in self.schema if n not in cols]
        if not keep:
            raise ValueError("drop() would remove every column")
        if len(keep) == len(self.schema):
            return self
        return self.select(*keep)

    def collect(self):
        return self.rdd.collect()

    def count(self):
        return self.rdd.count()

    def getNumPartitions(self):
        return self.rdd.getNumPartitions()

    def repartition(self, n):
        return DataFrame(self.rdd.repartition(n), self.schema)


def create_dataframe(ctx, data, schema=None, num_slices=None):
    """rows (dicts, or tuples + column-name schema) -> DataFrame.

    ``schema``: [(name, dtype)] or [name, ...] (dtypes inferred) or None
    (rows must be dicts; schema inferred from the first row).
    """
    data = list(data)
    if not data:
        raise ValueError("cannot create DataFrame from empty data")
    first = data[0]
    if schema is None:
        if not isinstance(first, dict):
            raise ValueError("schema required for non-dict rows")
        schema = infer_schema_from_row(first)
    elif schema and not isinstance(schema[0], (list, tuple)):
        names = list(schema)
        if isinstance(first, dict):
            schema = [(n, _infer_dtype(first[n])) for n in names]
        else:
            schema = [(n, _infer_dtype(v)) for n, v in zip(names, first)]
            data = [dict(zip(names, row)) for row in data]
    elif not isinstance(first, dict):
        names = [n for n, _ in schema]
        data = [dict(zip(names, row)) for row in data]
    return DataFrame(ctx.parallelize(data, num_slices), schema)
