"""Column-oriented variant table: the ``vcfpp::BcfRecord`` query surface.

The port's copy of ``haplohyped_tpu.hostio.variants``.  The converter needs
only the framed biallelic-SNP subset; this is the analysis surface: the rest
of the reference's record API, reshaped from per-record C++ accessors into
columns over the whole file.

Construction is one threaded native pass (``hostio.native.vcf_index``:
decompress, line, tab and POS index), then array ops for the REF/ALT
geometry and the predicates' inputs: no per-record Python.  A failed native
build raises; there is no Python indexer in its place.  The object-shaped
columns (``id``, ``alts``, ``info``, ``filter``, ``format_keys``,
``sample_fields``, ``qual``) are built lazily on first access, one linear
pass each; the vectorised predicates never touch them.

Parity map (reference ``cpp/vcfpp.h``):

- ``CHROM/POS/Start/End/REF/ALT/QUAL`` accessors (``:1076-1154``;
  ``End = pos + rlen``, ``:1118-1127``) -> columns.
- ``isSNP`` (``:990-1000``), ``isIndel`` (``:951-963``), ``isMultiAllelics``
  (``:965-970``), ``isMultiAllelicSNP`` (``:973-987``), ``isSV`` (SVTYPE INFO
  present, ``:943-949``) -> vectorised predicates.
- ``getGenotypes`` int form: allele index with missing = -9 (``:546-589``);
  presence form: 0/1 with a missing sample coded het (1, 0) (``:483-533``)
  -> :meth:`VariantTable.genotypes`.
- ``gtPhase`` / ``isAllPhased`` / ``ploidy()`` (``:528-533``, ``:1270``) ->
  :meth:`gt_phase`, :meth:`is_all_phased`, :meth:`ploidy`.
- ``getINFO``/``getFORMAT`` tag getters (``:591-950``) -> :meth:`info_tag`,
  :meth:`format_tag` (typed by the header's declared Type).
"""

from __future__ import annotations

import numpy as np

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.vcf import _parse_region
from haplohyped_tpu_torch.hostio.writer import VcfHeader

_MISSING_GT = -9  # vcfpp.h:572


_POS_WIDTH = 12
_POW10 = np.array([10**i for i in range(_POS_WIDTH)], dtype=np.int64)


def _parse_pos(text: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Vectorized POS digit parse over [starts, ends) spans; non-digit or
    over-long (> 12 digit) fields yield 0.  Chunked to bound temporaries."""
    n = starts.shape[0]
    out = np.zeros(n, dtype=np.int64)
    step = 2_000_000
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        s, e = starts[lo:hi], ends[lo:hi]
        idx = s[:, None] + np.arange(_POS_WIDTH)[None, :]
        in_span = idx < e[:, None]
        chars = text[np.clip(idx, 0, text.shape[0] - 1)]
        is_digit = (chars >= ord("0")) & (chars <= ord("9"))
        ok = (is_digit | ~in_span).all(axis=1) & (e - s >= 1) & (
            e - s <= _POS_WIDTH
        )
        digits = np.where(in_span & is_digit, chars - ord("0"), 0).astype(np.int64)
        # right-align: weight for column k is 10^(len-1-k), via table lookup
        exp = (e - s).astype(np.int64)[:, None] - 1 - np.arange(_POS_WIDTH)[None, :]
        w = np.where(exp >= 0, _POW10[np.clip(exp, 0, _POS_WIDTH - 1)], 0)
        out[lo:hi] = np.where(ok, (digits * w).sum(axis=1), 0)
    return out


class VariantTable:
    """All records of one VCF, as columns (vectorized core + lazy object
    conveniences — see module docstring)."""

    def __init__(
        self,
        header: VcfHeader,
        text: np.ndarray,
        offs: np.ndarray,
        lens: np.ndarray,
        bounds_rel: np.ndarray,  # (n, 9) int32, tab positions relative to line start
        samples: list[str],
        pos: np.ndarray | None = None,
        _holder=None,
    ):
        self.header = header
        self._text = text
        self._offs = offs
        self._lens = lens
        self._b = bounds_rel
        self.samples = samples
        self._holder = _holder  # keeps native memory alive for the views
        self._cache: dict = {}

        # vectorized eager core ------------------------------------------
        if pos is None:
            pos = _parse_pos(text, self._babs(0) + 1, self._babs(1))
        self.pos = pos
        self._ref_len = bounds_rel[:, 3] - bounds_rel[:, 2] - 1
        self._alt_len = bounds_rel[:, 4] - bounds_rel[:, 3] - 1
        self._alt_first = text[
            np.clip(self._babs(3) + 1, 0, max(text.shape[0] - 1, 0))
        ]

    def _babs(self, k: int) -> np.ndarray:
        """Absolute byte position of tab k per line."""
        return self._offs + self._b[:, k]

    # -- construction -----------------------------------------------------

    @classmethod
    def from_vcf(cls, path: str, region: str | None = None) -> "VariantTable":
        chrom_f, beg, end = _parse_region(region)
        # one threaded native pass: decompress + line/tab/POS indexing
        holder = native.vcf_index(path, threads=2)
        text, offs, lens = holder.text, holder.line_offsets, holder.line_lengths
        bounds, pos = holder.bounds, holder.pos
        samples = list(holder.samples)
        header_end = int(offs[0]) if offs.shape[0] else text.shape[0]
        header_text = text[:header_end].tobytes().decode(errors="replace")
        header = VcfHeader.from_text(header_text)
        if not samples:
            samples = header.get_samples()

        keep = bounds[:, 6] < lens  # >= 7 tabs = 8 fields (reference skips shorter)

        if chrom_f:
            cf = np.frombuffer(chrom_f.encode(), dtype=np.uint8)
            w = cf.shape[0]
            flen0 = bounds[:, 0].astype(np.int64)
            idx = offs[:, None] + np.arange(w)[None, :]
            eq = (
                text[np.clip(idx, 0, text.shape[0] - 1)] == cf[None, :]
            ).all(axis=1)
            keep &= (flen0 == w) & eq

        if not bool(keep.all()):  # common case: nothing filtered, no copies
            offs, lens, bounds = offs[keep], lens[keep], bounds[keep]
            if pos is not None:
                pos = pos[keep]
        table = cls(header, text, offs, lens, bounds, samples, pos=pos, _holder=holder)
        if chrom_f and (beg >= 0 or end >= 0):
            start0 = table.pos - 1
            m = np.ones(table.n, dtype=bool)
            if beg >= 0:
                m &= start0 >= beg
            if end >= 0:
                m &= start0 < end
            table = table._subset(m)
        return table

    def _subset(self, mask: np.ndarray) -> "VariantTable":
        return VariantTable(
            self.header,
            self._text,
            self._offs[mask],
            self._lens[mask],
            self._b[mask],
            self.samples,
            pos=self.pos[mask],
            _holder=self._holder,
        )

    # -- lazy object columns ------------------------------------------------

    def _field_strs(self, k: int) -> list[str]:
        """Field k of every record as Python strings (one linear pass)."""
        t = self._text
        lo = (self._offs if k == 0 else self._babs(k - 1) + 1).tolist()
        hi = self._babs(k).tolist()
        tb = t.tobytes()
        return [tb[a:b].decode(errors="replace") for a, b in zip(lo, hi)]

    def _lazy(self, name: str, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def chrom(self) -> np.ndarray:
        return self._lazy(
            "chrom", lambda: np.array(self._field_strs(0), dtype=object)
        )

    @property
    def id(self) -> np.ndarray:
        return self._lazy("id", lambda: np.array(self._field_strs(2), dtype=object))

    @property
    def ref(self) -> np.ndarray:
        return self._lazy("ref", lambda: np.array(self._field_strs(3), dtype=object))

    @property
    def alts(self) -> list[tuple[str, ...]]:
        def build():
            return [
                () if a == "." else tuple(a.split(",")) for a in self._field_strs(4)
            ]

        return self._lazy("alts", build)

    @property
    def qual(self) -> np.ndarray:
        def build():
            out = np.full(self.n, np.nan, dtype=np.float32)
            for i, q in enumerate(self._field_strs(5)):
                if q not in (".", ""):
                    out[i] = float(q)
            return out

        return self._lazy("qual", build)

    @property
    def filter(self) -> np.ndarray:
        return self._lazy(
            "filter", lambda: np.array(self._field_strs(6), dtype=object)
        )

    @property
    def info(self) -> list[dict]:
        def build():
            out = []
            for raw in self._field_strs(7):
                d: dict = {}
                if raw not in (".", ""):
                    for item in raw.split(";"):
                        if "=" in item:
                            k, v = item.split("=", 1)
                            d[k] = v
                        elif item:
                            d[item] = True
                out.append(d)
            return out

        return self._lazy("info", build)

    @property
    def format_keys(self) -> list[tuple[str, ...]]:
        def build():
            ntab = (self._b < self._lens[:, None]).sum(axis=1)
            return [
                tuple(f.split(":")) if nt >= 8 else ()
                for f, nt in zip(self._field_strs(8), ntab)
            ]

        return self._lazy("format_keys", build)

    @property
    def sample_fields(self) -> list[list[str]]:
        def build():
            tb = self._text.tobytes()
            ends = (self._offs + self._lens).tolist()
            starts = (self._babs(8) + 1).tolist()
            out = []
            for a, b in zip(starts, ends):
                out.append(tb[a:b].decode(errors="replace").split("\t") if a < b else [])
            return out

        return self._lazy("sample_fields", build)

    # -- coordinates --------------------------------------------------------

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])

    @property
    def start(self) -> np.ndarray:
        """0-based start (``BcfRecord::Start``, vcfpp.h:1118)."""
        return self.pos - 1

    @property
    def end(self) -> np.ndarray:
        """0-based exclusive end = start + len(REF) (``End()``, vcfpp.h:1127)."""
        return self.pos - 1 + self._ref_len

    def _n_allele(self) -> np.ndarray:
        """1 + ALT allele count: vectorized comma count inside the ALT span
        (missing ALT '.' counts zero)."""
        return self._lazy("_n_allele", self._n_allele_build)

    def _n_allele_build(self) -> np.ndarray:
        t = self._text
        lo, hi = self._babs(3) + 1, self._babs(4)
        n_alt = np.ones(self.n, dtype=np.int32)
        commas = np.flatnonzero(t == ord(","))
        if commas.shape[0]:
            n_alt += (
                np.searchsorted(commas, hi) - np.searchsorted(commas, lo)
            ).astype(np.int32)
        missing = (self._alt_len == 1) & (self._alt_first == ord("."))
        n_alt[missing] = 0  # '.' ALT -> REF-only record (1 allele total)
        return (1 + n_alt).astype(np.int32)

    # -- predicates (vectorized BcfRecord::is*) -------------------------------

    def is_sv(self) -> np.ndarray:
        """SVTYPE INFO tag present (vcfpp.h:943-949) — vectorized substring
        scan of the INFO span."""
        t = self._text
        tag = np.frombuffer(b"SVTYPE", dtype=np.uint8)
        lo, hi = self._babs(6) + 1, self._babs(7)
        width = int((hi - lo).max()) if self.n else 0
        if width < tag.shape[0]:
            return np.zeros(self.n, dtype=bool)
        if width > 128:
            # very wide INFO: the dense window would blow memory; the lazy
            # dict pass is cheaper there
            return np.array(["SVTYPE" in d for d in self.info], dtype=bool)
        idx = lo[:, None] + np.arange(width)[None, :]
        chars = t[np.clip(idx, 0, t.shape[0] - 1)]
        chars = np.where(idx < hi[:, None], chars, 0)
        hit = np.zeros(self.n, dtype=bool)
        for k in range(width - tag.shape[0] + 1):
            hit |= (chars[:, k : k + tag.shape[0]] == tag[None, :]).all(axis=1)
        return hit

    def is_snp(self) -> np.ndarray:
        """Exclusively biallelic SNP: one ALT ∈ {A,C,G,T}, REF length 1
        (vcfpp.h:990-1000)."""
        one_alt = self._n_allele() == 2
        acgt = np.isin(self._alt_first, np.frombuffer(b"ACGT", np.uint8))
        return (self._ref_len == 1) & one_alt & (self._alt_len == 1) & acgt

    def is_indel(self) -> np.ndarray:
        """Exclusively INDEL (vcfpp.h:951-963): length-changing allele (or
        missing ALT '.') at a non-SV site."""
        sv = self.is_sv()
        na = self._n_allele()
        out = (self._ref_len > 1) & ~sv
        # missing ALT '.'
        out |= (self._alt_len == 1) & (self._alt_first == ord("."))
        # single-ALT fast path: length differs
        single = na <= 2
        out |= single & (self._alt_len != self._ref_len) & ~sv & (
            self._alt_first != ord(".")
        )
        # multi-ALT rows: per-allele lengths need the split (rare rows only)
        multi = np.flatnonzero(~single & ~out)
        if multi.shape[0]:
            alts = self.alts
            ref_len = self._ref_len
            for i in multi:
                for alt in alts[i]:
                    if alt == "." or (len(alt) != ref_len[i] and not sv[i]):
                        out[i] = True
                        break
        return out

    def is_multiallelics(self) -> np.ndarray:
        """More than 2 alleles (vcfpp.h:965-970)."""
        return self._n_allele() > 2

    def is_multiallelic_snp(self) -> np.ndarray:
        """Multiallelic with REF length 1 and all single-base ALTs
        (vcfpp.h:973-987): k ALTs, all length 1 -> ALT span is 2k-1 bytes."""
        na = self._n_allele()
        k = na - 1
        return (self._ref_len == 1) & (na > 2) & (self._alt_len == 2 * k - 1)

    # -- genotypes -------------------------------------------------------------

    def ploidy(self) -> int:
        """Max ploidy across the first record's samples (vcfpp nploidy)."""
        for gts, fmt in zip(self.sample_fields, self.format_keys):
            if "GT" in fmt and gts:
                gi = fmt.index("GT")
                return max(
                    len(g.split(":")[gi].replace("|", "/").split("/")) for g in gts
                )
        return 0

    def _gt_iter(self):
        for fmt, row in zip(self.format_keys, self.sample_fields):
            gi = fmt.index("GT") if "GT" in fmt else -1
            yield gi, row

    def genotypes(self, presence: bool = False) -> np.ndarray:
        """(n_variants, n_samples, ploidy) int8 allele matrix.

        ``presence=False`` → allele index, missing allele = -9
        (``getGenotypes(vector<int>&)``, vcfpp.h:546-589).
        ``presence=True`` → allele presence 0/1 with a missing *sample*
        coded (1, 0) (``getGenotypes<T>``, vcfpp.h:483-533) — the form the
        cohort pipeline stores as phase1/phase2.  (The HOT path for this
        form is the v2 framer + device decode; this is the analysis twin.)
        """
        P = max(self.ploidy(), 1)
        S = len(self.samples)
        out = np.full((self.n, S, P), _MISSING_GT, dtype=np.int8)
        for i, (gi, row) in enumerate(self._gt_iter()):
            if gi < 0:
                continue
            for s, cell in enumerate(row[:S]):
                g = cell.split(":")[gi]
                parts = g.replace("|", "/").split("/")
                if presence and any(x == "." for x in parts):
                    out[i, s, 0] = 1
                    out[i, s, 1:] = 0
                    continue
                for j, av in enumerate(parts[:P]):
                    if av == ".":
                        out[i, s, j] = _MISSING_GT
                    elif presence:
                        out[i, s, j] = 1 if int(av) != 0 else 0
                    else:
                        out[i, s, j] = min(int(av), 127)
        if presence:
            out[out == _MISSING_GT] = 0
        return out

    def gt_phase(self) -> np.ndarray:
        """(n_variants, n_samples) bool: every allele separator is '|'
        (gtPhase semantics — phase bit of the non-first alleles,
        vcfpp.h:528; haploid calls are unphased like htslib's text parser)."""
        S = len(self.samples)
        out = np.zeros((self.n, S), dtype=bool)
        for i, (gi, row) in enumerate(self._gt_iter()):
            if gi < 0:
                continue
            for s, cell in enumerate(row[:S]):
                g = cell.split(":")[gi]
                out[i, s] = "|" in g and "/" not in g
        return out

    def is_all_phased(self) -> np.ndarray:
        """(n_variants,) bool (isAllPhased, vcfpp.h:533)."""
        ph = self.gt_phase()
        return ph.all(axis=1) if ph.size else np.zeros(self.n, dtype=bool)

    # -- tags --------------------------------------------------------------------

    def info_tag(self, tag: str):
        """Typed INFO column: Integer/Float → float64 array (NaN missing,
        first value of vectors), Flag → bool array, else object array of
        raw strings (getINFO parity, vcfpp.h:591-697)."""
        itype = self.header.info_type(tag)
        if itype == "Flag":
            return np.array([bool(d.get(tag, False)) for d in self.info], dtype=bool)
        raw = [d.get(tag) for d in self.info]
        if itype in ("Integer", "Float"):
            out = np.full(self.n, np.nan)
            for i, v in enumerate(raw):
                if v is not None and v is not True:
                    out[i] = float(str(v).split(",")[0])
            return out
        return np.array([v if v is not None else "" for v in raw], dtype=object)

    def format_tag(self, tag: str) -> np.ndarray:
        """(n_variants, n_samples) FORMAT subfield values ('' when absent),
        numeric dtype when the header declares Integer/Float
        (getFORMAT parity, vcfpp.h:596-653)."""
        S = len(self.samples)
        vals = np.empty((self.n, S), dtype=object)
        vals[:] = ""
        for i, (fmt, row) in enumerate(zip(self.format_keys, self.sample_fields)):
            if tag not in fmt:
                continue
            ti = fmt.index(tag)
            for s, cell in enumerate(row[:S]):
                parts = cell.split(":")
                if ti < len(parts):
                    vals[i, s] = parts[ti]
        ftype = None
        for l in self.header.lines:
            if l.startswith("##FORMAT=<") and VcfHeader._line_id(l) == tag and "Type=" in l:
                ftype = l.split("Type=", 1)[1].split(",", 1)[0].split(">", 1)[0]
        if ftype in ("Integer", "Float"):
            num = np.full((self.n, S), np.nan)
            for i in range(self.n):
                for s in range(S):
                    v = vals[i, s]
                    if v not in ("", "."):
                        num[i, s] = float(str(v).split(",")[0])
            return num
        return vals
