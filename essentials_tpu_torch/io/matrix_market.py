"""Matrix Market (.mtx) reader.

Counterpart of ``essentials_tpu/io/matrix_market.py`` (reference parity:
io::matrix_market_t::load and the vendored mmio.c, gunrock
``io/matrix_market.hxx:71-241``), re-implemented from the public
MatrixMarket spec: banner parsing, ``%`` comments, 1-based coordinate
triples, ``pattern`` fields defaulting to weight 1.0, and symmetric /
skew-symmetric expansion duplicating off-diagonal entries.

``load_mtx`` reads a coordinate file with the port's native C++ parser
(``native/mmio.cpp``, built at first use) unless ``use_native=False``; a
file in array format goes to the NumPy bulk parser, which reads both
formats. Where the native parser cannot be built, ``load_mtx`` raises: it
does not fall back to NumPy as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.coo import Coo

_FIELDS = ("real", "integer", "pattern", "complex")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


def _parse_banner(line: str):
    parts = line.strip().lower().split()
    throw_if(len(parts) != 5 or parts[0] != "%%matrixmarket",
             f"not a MatrixMarket banner: {line!r}")
    _, obj, fmt, field, sym = parts
    throw_if(obj != "matrix", f"unsupported MatrixMarket object: {obj}")
    throw_if(fmt not in ("coordinate", "array"),
             f"unsupported MatrixMarket format: {fmt}")
    throw_if(field not in _FIELDS, f"unsupported field: {field}")
    throw_if(sym not in _SYMMETRIES, f"unsupported symmetry: {sym}")
    return fmt, field, sym


def load_mtx(path, *, expand_symmetric: bool = True,
             use_native: bool = True) -> Coo:
    """Read a .mtx file into a host Coo.

    Pattern matrices get weight 1.0 (matrix_market.hxx:146-164 parity);
    symmetric matrices are expanded by mirroring off-diagonal entries
    (matrix_market.hxx:194-235 parity) unless ``expand_symmetric=False``.
    The native parser keeps each mirrored entry beside its original, the
    NumPy parser appends the mirrors: the same entries in another order.
    """
    if use_native:
        from essentials_tpu_torch.native import mmio_native
        out = mmio_native.load_mtx(str(path), expand_symmetric)
        if out is not None:
            return Coo(*out)
    with open(path, "rb") as f:
        data = f.read()
    return parse_mtx_bytes(data, expand_symmetric=expand_symmetric)


def parse_mtx_bytes(data: bytes, *, expand_symmetric: bool = True) -> Coo:
    text = data.decode("latin-1")
    # Banner is the first line; comments start with %.
    nl = text.find("\n")
    throw_if(nl < 0, "empty mtx file")
    fmt, field, sym = _parse_banner(text[:nl])
    pos = nl + 1
    # Skip comment/blank lines to the size line.
    while True:
        nl = text.find("\n", pos)
        line = text[pos:nl if nl >= 0 else len(text)].strip()
        if line and not line.startswith("%"):
            break
        throw_if(nl < 0, "mtx: missing size line")
        pos = nl + 1
    size_parts = line.split()
    pos = (nl + 1) if nl >= 0 else len(text)
    body = text[pos:]

    if fmt == "array":
        return _parse_dense(body, size_parts, field, sym)

    throw_if(len(size_parts) != 3, f"mtx: bad size line {line!r}")
    n_rows, n_cols, nnz = (int(x) for x in size_parts)

    # Bulk-parse the body. Comments inside the body are rare but legal.
    if "%" in body:
        body = "\n".join(l for l in body.splitlines() if not l.lstrip().startswith("%"))
    cols_per = {"pattern": 2, "complex": 4}.get(field, 3)
    # float64 holds 31-bit indices exactly; one bulk parse beats per-line loops.
    arr = np.array(body.split(), dtype=np.float64)
    throw_if(arr.size < nnz * cols_per,
             f"mtx: expected {nnz} entries x {cols_per} fields, got {arr.size} tokens")
    arr = arr[: nnz * cols_per].reshape(nnz, cols_per)
    rows = arr[:, 0].astype(np.int64) - 1
    cols = arr[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(nnz, dtype=dtypes.weight_dtype)
    else:
        vals = arr[:, 2].astype(dtypes.weight_dtype)  # complex: real part only

    if sym in ("symmetric", "skew-symmetric", "hermitian") and expand_symmetric:
        off = rows != cols
        mr, mc = cols[off], rows[off]
        mv = -vals[off] if sym == "skew-symmetric" else vals[off]
        rows = np.concatenate([rows, mr])
        cols = np.concatenate([cols, mc])
        vals = np.concatenate([vals, mv])

    return Coo(n_rows, n_cols,
               rows.astype(dtypes.vertex_dtype), cols.astype(dtypes.vertex_dtype), vals)


def _parse_dense(body: str, size_parts, field: str, sym: str) -> Coo:
    """`array` format: column-major dense values -> Coo of nonzeros."""
    throw_if(len(size_parts) != 2, "mtx array: bad size line")
    n_rows, n_cols = (int(x) for x in size_parts)
    throw_if(field == "pattern", "mtx array format cannot be pattern")
    vals = np.array(body.split(), dtype=np.float64)
    if field == "complex":
        vals = vals.reshape(-1, 2)[:, 0]
    if sym == "general":
        throw_if(vals.size != n_rows * n_cols, "mtx array: wrong value count")
        dense = vals.reshape(n_cols, n_rows).T
    else:
        # Lower triangle stored column-major.
        dense = np.zeros((n_rows, n_cols))
        k = 0
        for j in range(n_cols):
            m = n_rows - j
            dense[j:, j] = vals[k:k + m]
            k += m
        mirror = dense.T.copy()
        np.fill_diagonal(mirror, 0)
        dense = dense + (-mirror if sym == "skew-symmetric" else mirror)
    r, c = np.nonzero(dense)
    return Coo(n_rows, n_cols, r.astype(dtypes.vertex_dtype),
               c.astype(dtypes.vertex_dtype), dense[r, c].astype(dtypes.weight_dtype))


def write_mtx(path, coo: Coo, *, field: str = "real") -> None:
    """Write a Coo as a general coordinate .mtx (round-trip/testing utility)."""
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{coo.n_rows} {coo.n_cols} {coo.nnz}\n")
        if field == "pattern":
            np.savetxt(f, np.stack([coo.row_indices + 1,
                                    coo.col_indices + 1], 1), fmt="%d")
        else:
            np.savetxt(
                f,
                np.stack([coo.row_indices + 1.0, coo.col_indices + 1.0,
                          coo.values.astype(np.float64)], 1),
                fmt=("%d", "%d", "%.9g"),
            )
