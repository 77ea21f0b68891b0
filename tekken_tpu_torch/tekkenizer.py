"""The Tekkenizer of the PyTorch port: the public tokenizer API.

Parity surface (reference: src/tekkenizer.rs):
- construction + validation           (src/tekkenizer.rs:71-191)
- ``from_file``                       (src/tekkenizer.rs:222-248)
- ``encode(text, add_bos, add_eos)``  (src/tekkenizer.rs:378-405)
- ``decode`` / ``decode_all``         (src/tekkenizer.rs:436-511)
- id helpers and vocab access         (src/tekkenizer.rs:281-700)

Token-id spaces: special tokens sit at ``0..num_special_tokens`` and
engine ranks are shifted up by ``num_special_tokens``.

``encode`` runs on the host through the native C++ engine (native/, built
with g++ at first use; the oracle with ``native=False``) and ``decode`` on
the host in Python; ``encode_batch`` runs the packed pipeline and
``decode_batch`` the device decoder on ``device`` ("cuda" unless the
caller asks for "cpu").  Every engine raises on any failure: there is no
quiet fallback to another.  ``engine_used`` names the engine of the last
call.  ``encode_audio`` does the reference's frame math on the host
(src/tekkenizer.rs:728-735); the audio encoder's mel spectrogram runs on
``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .audio import Audio, AudioConfig, AudioEncoder, AudioEncoding
from .config import ModelData, TokenInfo, TokenizerVersion, parse_version
from .errors import (
    AudioError,
    InvalidConfigError,
    SpecialTokenPolicyError,
    TokenizersError,
    TokenNotFoundError,
)
from .oracle import TEKKEN_PATTERN, encode_ranks
from .special_tokens import (
    SpecialTokenInfo,
    SpecialTokenPolicy,
    SpecialTokens,
    get_deprecated_special_tokens,
)
from .utils.timing import COUNTERS, mark, span
from .vocab import (
    CuckooPairTable,
    CuckooPieceTable,
    DecodeTable,
    PairTable,
    WordDirectMap,
    reload_mergeable_ranks,
)

# the most bytes one packed buffer of encode_batch holds: larger batches
# run as several row sub-batches, and a doc longer than an 8-row buffer's
# row (MAX_BATCH_BYTES / 8) is cut into rows at piece-safe points
MAX_BATCH_BYTES = 1 << 24


def _pow2(n: int, lo: int) -> int:
    """The smallest power-of-two multiple of ``lo`` that is >= n."""
    b = lo
    while b < n:
        b <<= 1
    return b


class Tekkenizer:
    """Multimodal Tekken tokenizer (reference: src/tekkenizer.rs:34-44)."""

    def __init__(
        self,
        vocab: list[TokenInfo],
        special_tokens: list[SpecialTokenInfo],
        pattern: str,
        vocab_size: int,
        num_special_tokens: int,
        version: TokenizerVersion,
        audio_config: Optional[AudioConfig] = None,
        device="cuda",
        native: bool = True,
    ):
        if vocab_size > len(vocab) + num_special_tokens:
            raise InvalidConfigError(
                f"vocab_size ({vocab_size}) must be <= vocab.len() "
                f"({len(vocab)}) + num_special_tokens ({num_special_tokens})")

        seen = set()
        for tok in special_tokens:
            if tok.token_str in seen:
                raise InvalidConfigError(
                    f"Duplicate special token: {tok.token_str}")
            seen.add(tok.token_str)

        if len(special_tokens) > num_special_tokens:
            raise InvalidConfigError(
                f"special_tokens.len() ({len(special_tokens)}) must be <= "
                f"num_special_tokens ({num_special_tokens})")

        all_special = list(special_tokens)
        for i in range(len(special_tokens), num_special_tokens):
            all_special.append(SpecialTokenInfo(
                rank=i, token_str=f"<SPECIAL_{i}>", is_control=True))

        ranks = reload_mergeable_ranks(vocab, vocab_size - num_special_tokens)

        # the reference ignores config.pattern and hardcodes the Tekken
        # pattern (reference: src/tekkenizer.rs:74,123)
        del pattern
        self._pattern = TEKKEN_PATTERN
        self._special_tokens_map = {t.token_str: t.rank for t in all_special}
        self._decode_table = DecodeTable.build(ranks)

        n_ranks = len(ranks)
        vocab_strings = [t.token_str for t in all_special]
        for i in range(vocab_size - num_special_tokens):
            if i < n_ranks:
                vocab_strings.append(self._decode_table.token_bytes(i).decode(
                    "utf-8", errors="replace"))
            else:
                vocab_strings.append("<?>")

        # audio wiring (reference: src/tekkenizer.rs:157-178)
        audio_encoder = None
        if audio_config is not None:
            audio_id = self._special_tokens_map.get(SpecialTokens.AUDIO.as_str())
            if audio_id is None:
                raise TokenNotFoundError("Audio token not found")
            begin_audio_id = self._special_tokens_map.get(
                SpecialTokens.BEGIN_AUDIO.as_str())
            if begin_audio_id is None:
                raise TokenNotFoundError("BeginAudio token not found")
            audio_encoder = AudioEncoder(
                config=audio_config,
                audio_token_id=audio_id,
                begin_audio_token_id=begin_audio_id,
                device=device,
            )

        self._ranks = ranks
        self._vocab_size = vocab_size
        self._num_special_tokens = num_special_tokens
        self._version = version
        self._special_tokens = all_special
        self._vocab_strings = vocab_strings
        self._audio_config = audio_config
        self._audio_encoder = audio_encoder
        self._device = device
        # the host engine: the native C++ engine, or the oracle when the
        # caller passes native=False
        self._native = native
        self._native_encoder = None
        self._last_engine: Optional[str] = None
        self._cuckoo_table: Optional[CuckooPairTable] = None
        self._pair_table: Optional[PairTable] = None
        self._piece_table: Optional[CuckooPieceTable] = None
        self._word_map: Optional[WordDirectMap] = None
        self._device_tables: dict = {}
        self._packed_encoders: dict = {}
        self._device_decoder = None
        self._last_batch_stats: dict = {}

    @classmethod
    def from_file(cls, path, device="cuda",
                  native: bool = True) -> "Tekkenizer":
        """Load from a tekken.json model file
        (reference: src/tekkenizer.rs:222-248)."""
        return cls.from_model_data(ModelData.from_file(path), device=device,
                                   native=native)

    @classmethod
    def from_model_data(cls, model_data: ModelData, device="cuda",
                        native: bool = True) -> "Tekkenizer":
        version = parse_version(model_data.config.version)
        special_tokens = model_data.special_tokens
        if special_tokens is None:
            special_tokens = get_deprecated_special_tokens()
        return cls(
            vocab=model_data.vocab,
            special_tokens=special_tokens,
            pattern=model_data.config.pattern,
            vocab_size=model_data.config.default_vocab_size,
            num_special_tokens=model_data.config.default_num_special_tokens,
            version=version,
            audio_config=model_data.audio,
            device=device,
            native=native,
        )

    # ------------------------------------------------------------------ #
    # metadata accessors
    # ------------------------------------------------------------------ #

    def vocab_size(self) -> int:
        return self._vocab_size

    def num_special_tokens(self) -> int:
        return self._num_special_tokens

    def version(self) -> TokenizerVersion:
        return self._version

    def vocab(self) -> list[str]:
        return self._vocab_strings

    def get_control_token(self, token_str: str) -> int:
        rank = self._special_tokens_map.get(token_str)
        if rank is None:
            available = list(self._special_tokens_map.keys())
            raise TokenNotFoundError(
                f"Unknown control token: '{token_str}'. "
                f"Available special tokens: {available!r}")
        return rank

    def bos_id(self) -> int:
        return self.get_control_token(SpecialTokens.BOS.as_str())

    def eos_id(self) -> int:
        return self.get_control_token(SpecialTokens.EOS.as_str())

    def pad_id(self) -> int:
        return self.get_control_token(SpecialTokens.PAD.as_str())

    def unk_id(self) -> int:
        return self.get_control_token(SpecialTokens.UNK.as_str())

    def is_special_token(self, token_id: int) -> bool:
        return 0 <= token_id < self._num_special_tokens

    def is_byte(self, token_id: int) -> bool:
        if token_id < self._num_special_tokens:
            return False
        return (token_id - self._num_special_tokens) < 256

    # ------------------------------------------------------------------ #
    # encode
    # ------------------------------------------------------------------ #

    def _with_specials(self, ranks, bos: bool, eos: bool) -> list[int]:
        shift = self._num_special_tokens
        toks = [r + shift for r in ranks]
        if bos:
            toks.insert(0, self.bos_id())
        if eos:
            toks.append(self.eos_id())
        return toks

    def encode(self, text: str, add_beginning_of_sequence: bool,
               add_end_of_sequence: bool) -> list[int]:
        """Encode one string on the host (reference: src/tekkenizer.rs:378-405)."""
        return self._with_specials(self._encode_ranks_host(text),
                                   add_beginning_of_sequence,
                                   add_end_of_sequence)

    def _encode_ranks_host(self, text: str) -> list[int]:
        """Engine ranks of one string by the host engine: the native C++
        engine, or the oracle when the tokenizer was made with
        ``native=False``."""
        ranks = self._host_ranks(text)
        self._last_engine = "native-host" if self._native else "host-oracle"
        return ranks

    def _host_ranks(self, text: str) -> list[int]:
        native = self._get_native_encoder()
        if native is not None:
            return native.encode(text)
        return encode_ranks(text, self._ranks)

    def _host_merge_fn(self):
        """The host's merge of pre-split pieces, as ``splice_host_merges``
        takes it: the native engine's ``merge_spans``, or the oracle's
        byte_pair_merge with ``native=False``."""
        native = self._get_native_encoder()
        if native is not None:
            return native.merge_spans
        from .ops.packed import oracle_merge_fn

        return oracle_merge_fn(self._ranks)

    def _get_native_encoder(self):
        """The native engine (built at first use), or None when the caller
        asked for the oracle (``native=False``).  A failed build or load
        raises: nothing falls back to the oracle."""
        if not self._native:
            return None
        if self._native_encoder is None:
            from .native import NativeEncoder

            self._native_encoder = NativeEncoder(self)
        return self._native_encoder

    @property
    def engine_used(self) -> Optional[str]:
        """The engine of the most recent encode or decode_batch call:
        "packed-device", "native-host", "host-oracle" or "device-decode"
        (None before any call)."""
        return self._last_engine

    def encode_batch(
        self,
        texts: Sequence[str],
        add_beginning_of_sequence: bool = False,
        add_end_of_sequence: bool = False,
        clock=None,
    ) -> list[list[int]]:
        """Batched encode on the device through the packed pipeline, in
        power-of-two shape buckets (rows >= 8, row length >= 256).  A batch
        whose buffer would exceed MAX_BATCH_BYTES runs as consecutive row
        sub-batches that each fit.  A doc longer than MAX_BATCH_BYTES / 8
        bytes is cut at piece-safe points (``ops.packed.
        piece_safe_segments``): its segments run as rows of the same
        sub-batches, the pieces that cannot be cut are merged on the host,
        piece by piece (``_host_merge_fn``), and its ids are their
        concatenation in order.  ``clock`` (a ``utils.timing.StageClock``,
        measurement only) records the wall time of each pipeline stage and
        the spans of the layers, ``tekken.encode_batch`` their root."""
        with span("tekken.encode_batch", clock) as root:
            before = dict(COUNTERS.totals)
            COUNTERS.add("encode_calls", 1)
            with span("tekken.plan", clock):
                rows, plans, n_bytes = self._cut_oversize(texts)
                batches = self._row_batches(rows)
            if root is not None:
                root.attrs.update(docs=len(texts), bytes=n_bytes)
            rank_lists: list[list[int]] = []
            for sub in batches:
                with span("tekken.plan", clock):
                    enc = self._get_packed_encoder(sub)
                rank_lists += enc.encode_batch(sub, clock=clock)
            self._last_batch_stats = COUNTERS.since(before)
            self._last_engine = "packed-device"
            with span("tekken.public_ids", clock):
                if plans is not None:
                    rank_lists = [[r for part in plan for r in (
                        rank_lists[part] if isinstance(part, int) else part)]
                        for plan in plans]
                out = [self._with_specials(r, add_beginning_of_sequence,
                                           add_end_of_sequence)
                       for r in rank_lists]
                mark(clock, "public_ids")
            return out

    def _cut_oversize(self, texts):
        """(rows, plans, n_bytes), n_bytes the UTF-8 bytes of ``texts``.
        Without a doc over MAX_BATCH_BYTES / 8 bytes the rows are ``texts``
        and plans is None.  Otherwise each such doc is cut into piece-safe
        segments (the plan of CorpusEncoder.encode_stream): a segment that
        fits becomes a row, the pieces that do not are merged on the host
        now; a doc's plan lists, in order, the indices of its rows and the
        host-merged rank lists."""
        budget = MAX_BATCH_BYTES // 8
        sizes = [len(t.encode("utf-8")) for t in texts]
        over = [n > budget for n in sizes]
        if not any(over):
            return texts, None, sum(sizes)
        from .ops.packed import piece_safe_segments

        rows: list[str] = []
        plans: list[list] = []
        for t, oversize in zip(texts, over):
            if not oversize:
                plans.append([len(rows)])
                rows.append(t)
                continue
            plan: list = []
            for kind, val in piece_safe_segments(t, budget):
                if kind == "d":
                    plan.append(len(rows))
                    rows.append(val)
                else:
                    plan.append(self._merge_pieces(
                        [val] if kind == "h" else val))
            plans.append(plan)
        return rows, plans, sum(sizes)

    def _merge_pieces(self, pieces: list[str]) -> list[int]:
        """The ranks of pre-tokenization pieces, each merged on its own on
        the host, concatenated."""
        datas = [p.encode("utf-8") for p in pieces]
        lens = np.fromiter(map(len, datas), np.int64, len(datas))
        buf = np.frombuffer(b"".join(datas), dtype=np.uint8)
        toks, _ = self._host_merge_fn()(buf, np.cumsum(lens) - lens, lens)
        return np.asarray(toks).tolist()

    @staticmethod
    def _row_batches(texts):
        """``texts`` (none over MAX_BATCH_BYTES / 8 bytes) in consecutive
        sub-batches whose packed buffers each hold at most MAX_BATCH_BYTES
        (one sub-batch when the whole batch fits)."""
        max_len = max((len(t.encode("utf-8")) for t in texts), default=1)
        rows = MAX_BATCH_BYTES // _pow2(max_len, 256)
        if len(texts) <= rows:
            return [texts]
        return [texts[i:i + rows] for i in range(0, len(texts), rows)]

    @property
    def last_batch_stats(self) -> dict:
        """Counts of the last encode_batch (a view of its increments of
        ``utils.timing.COUNTERS``): rows re-encoded on the host after a
        bucket overflow (``overflow_rows``), spans merged and spliced on the
        host (``fb_spans``), misses over 8 bytes merged on the device
        (``device_long_rows``)."""
        return self._last_batch_stats

    def _get_packed_encoder(self, texts):
        """The packed encoder of the batch's shape bucket (the batch fits
        MAX_BATCH_BYTES: ``_row_batches`` splits it first)."""
        from .ops.packed import PackedEncoder

        max_len = max((len(t.encode("utf-8")) for t in texts), default=1)
        rows = _pow2(max(1, len(texts)), 8)
        row_len = _pow2(max_len, 256)
        key = (rows, row_len)
        enc = self._packed_encoders.get(key)
        if enc is None:
            enc = PackedEncoder(self, rows=rows, row_len=row_len,
                                device=self._device)
            self._packed_encoders[key] = enc
        return enc

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #

    def to_model_data(self) -> ModelData:
        import base64 as _b64

        from .config import TekkenConfig

        n_ranks = len(self._decode_table.offsets) - 1
        vocab = [
            TokenInfo(rank=r,
                      token_bytes=_b64.b64encode(
                          self._decode_table.token_bytes(r)).decode("ascii"),
                      token_str=None)
            for r in range(n_ranks)
        ]
        config = TekkenConfig(
            pattern=self._pattern,
            num_vocab_tokens=n_ranks,
            default_vocab_size=self._vocab_size,
            default_num_special_tokens=self._num_special_tokens,
            version=self._version.as_str(),
        )
        return ModelData(vocab=vocab, config=config,
                         special_tokens=list(self._special_tokens),
                         audio=self._audio_config)

    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_model_data().to_json())

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #

    def decode_batch(self, token_lists,
                     special_token_policy: SpecialTokenPolicy) -> list[str]:
        """Batched decode: every non-special token of the batch goes to the
        device decoder (ops/decode.py) in one rank stream, and the runs of
        the reference's decode_all grouping (src/tekkenizer.rs:463-560)
        are reassembled on the host with lossy UTF-8.  Errors are raised
        before any device work: RAISE on a special token, then an invalid
        id."""
        ns = self._num_special_tokens
        n_ranks = len(self._decode_table.offsets) - 1
        policy = special_token_policy

        # the plan, array-shaped: concatenate the batch, split it into
        # maximal same-specialness runs (a doc edge always breaks a run)
        sizes = np.fromiter((len(x) for x in token_lists), np.int64,
                            len(token_lists))
        T = int(sizes.sum())
        if T == 0:
            return ["" for _ in token_lists]
        allv = np.concatenate([np.asarray(x, dtype=np.int64).reshape(-1)
                               for x in token_lists if len(x)])
        doc_of = np.repeat(np.arange(len(token_lists)), sizes)
        sp = allv < ns
        if policy is SpecialTokenPolicy.RAISE and sp.any():
            # the message lists the offending run (src/tekkenizer.rs:531-535)
            p0 = int(np.argmax(sp))
            d0 = doc_of[p0]
            hi = p0
            while hi < T and sp[hi] and doc_of[hi] == d0:
                hi += 1
            raise SpecialTokenPolicyError(
                f"Decoding tokens that contain special tokens "
                f"({allv[p0:hi].tolist()!r}) is not allowed")
        ranks_all = allv[~sp] - ns
        if ranks_all.size and (int(ranks_all.min()) < 0
                               or int(ranks_all.max()) >= n_ranks):
            badpos = np.flatnonzero(~sp)[
                (ranks_all < 0) | (ranks_all >= n_ranks)][0]
            raise TokenizersError(
                f"Invalid token id for decode: {allv[badpos]}")

        # run cuts: specialness flips or doc edges
        brk = np.flatnonzero((sp[1:] != sp[:-1])
                             | (doc_of[1:] != doc_of[:-1])) + 1
        cuts = np.concatenate(([0], brk, [T]))
        run_doc = doc_of[cuts[:-1]]
        run_sp = sp[cuts[:-1]]

        # one device stream decodes every non-special token of the batch
        data = b""
        byte_cuts = rank_ord = None
        if ranks_all.size:
            stream = ranks_all.astype(np.int32)
            dec = self._get_device_decoder()
            ends = dec.byte_ends(stream)
            data = dec.decode_stream(stream, ends)
            self._last_engine = "device-decode"
            byte_cuts = np.concatenate(([0], ends))
            # rank ordinal of each batch position (exclusive count of
            # non-special tokens before it)
            rank_ord = np.cumsum(~sp) - (~sp).astype(np.int64)

        # assembly: one pass over runs, not tokens
        parts: list[list[str]] = [[] for _ in token_lists]
        keep = policy is SpecialTokenPolicy.KEEP
        for r in range(len(run_doc)):
            lo, hi = cuts[r], cuts[r + 1]
            if run_sp[r]:
                if keep:
                    parts[run_doc[r]].append("".join(
                        self._special_tokens[t].token_str
                        for t in allv[lo:hi]))
            else:
                blo = byte_cuts[rank_ord[lo]]
                bhi = byte_cuts[rank_ord[hi - 1] + 1]
                parts[run_doc[r]].append(
                    data[blo:bhi].decode("utf-8", errors="replace"))
        return ["".join(p) for p in parts]

    def _get_device_decoder(self):
        from .ops.decode import DeviceDecoder

        if self._device_decoder is None:
            self._device_decoder = DeviceDecoder(self, device=self._device)
        return self._device_decoder

    def decode(self, tokens: Sequence[int],
               special_token_policy: SpecialTokenPolicy) -> str:
        """Join of decode_all (reference: src/tekkenizer.rs:436-443)."""
        return "".join(self.decode_all(tokens, special_token_policy))

    def decode_all(self, tokens: Sequence[int],
                   special_token_policy: SpecialTokenPolicy) -> list[str]:
        """Decode into segments of maximal same-specialness runs
        (reference: src/tekkenizer.rs:463-511)."""
        decoded: list[str] = []
        group: list[int] = []
        group_is_special: Optional[bool] = None
        ns = self._num_special_tokens
        for token_id in tokens:
            is_special = token_id < ns
            if group_is_special is None:
                group_is_special = is_special
            if is_special == group_is_special:
                group.append(token_id)
            else:
                self._decode_group(group, group_is_special, decoded,
                                   special_token_policy)
                group = [token_id]
                group_is_special = is_special
        if group_is_special is not None:
            self._decode_group(group, group_is_special, decoded,
                               special_token_policy)
        return decoded

    def _decode_group(self, group: list[int], is_special: bool,
                      decoded: list[str],
                      policy: SpecialTokenPolicy) -> None:
        """(reference: src/tekkenizer.rs:522-560)"""
        if is_special:
            if policy is SpecialTokenPolicy.RAISE:
                raise SpecialTokenPolicyError(
                    f"Decoding tokens that contain special tokens "
                    f"({group!r}) is not allowed")
            if policy is SpecialTokenPolicy.KEEP:
                for token_id in group:
                    decoded.append(self._special_tokens[token_id].token_str)
        else:
            ns = self._num_special_tokens
            n_ranks = len(self._decode_table.offsets) - 1
            parts = []
            for t in group:
                rank = t - ns
                if rank < 0 or rank >= n_ranks:
                    raise TokenizersError(f"Invalid token id for decode: {t}")
                parts.append(self._decode_table.token_bytes(rank))
            decoded.append(b"".join(parts).decode("utf-8", errors="replace"))

    def id_to_piece(self, token_id: int) -> str:
        """Single-token string (reference: src/tekkenizer.rs:617-628)."""
        if token_id >= self._vocab_size or token_id < 0:
            raise InvalidConfigError(
                f"Token ID {token_id} is out of vocabulary range "
                f"(0-{self._vocab_size - 1})")
        return self.decode([token_id], SpecialTokenPolicy.KEEP)

    def id_to_byte_piece(self, token_id: int,
                         special_token_policy: SpecialTokenPolicy) -> bytes:
        """Single-token bytes (reference: src/tekkenizer.rs:648-695); a
        non-UTF-8 token falls back to its lossy vocab string, as the
        reference does."""
        if token_id >= self._vocab_size or token_id < 0:
            raise InvalidConfigError(
                f"Token ID {token_id} is out of vocabulary range "
                f"(0-{self._vocab_size - 1})")
        ns = self._num_special_tokens
        if token_id < ns:
            info = self._special_tokens[token_id]
            if special_token_policy is SpecialTokenPolicy.KEEP:
                return info.token_str.encode("utf-8")
            if special_token_policy is SpecialTokenPolicy.RAISE:
                raise SpecialTokenPolicyError(
                    f"Token ID {token_id} is a special token "
                    f"({info.token_str}), cannot convert to byte piece with "
                    f"Raise policy")
            return b""
        rank = token_id - ns
        n_ranks = len(self._decode_table.offsets) - 1
        if rank >= n_ranks:
            raise TokenizersError(
                f"Failed to decode token ID {token_id} to bytes: rank out of "
                f"range")
        raw = self._decode_table.token_bytes(rank)
        try:
            raw.decode("utf-8")
            return raw
        except UnicodeDecodeError:
            return self._vocab_strings[token_id].encode("utf-8")

    # ------------------------------------------------------------------ #
    # audio
    # ------------------------------------------------------------------ #

    def encode_audio(self, audio: Audio) -> AudioEncoding:
        """(reference: src/tekkenizer.rs:728-735)"""
        if self._audio_encoder is None:
            raise AudioError("Audio encoder not configured")
        return self._audio_encoder.encode(audio)

    def encode_audio_batch(self, audios: Sequence[Audio]) -> list[AudioEncoding]:
        if self._audio_encoder is None:
            raise AudioError("Audio encoder not configured")
        return self._audio_encoder.encode_batch(list(audios))

    def has_audio_support(self) -> bool:
        return self._audio_encoder is not None

    def audio_config(self) -> Optional[AudioConfig]:
        return self._audio_config

    # ------------------------------------------------------------------ #
    # tables
    # ------------------------------------------------------------------ #

    @property
    def ranks(self) -> dict[bytes, int]:
        """The engine-rank table (bytes -> rank)."""
        return self._ranks

    @property
    def decode_table(self) -> DecodeTable:
        return self._decode_table

    def cuckoo_table(self) -> CuckooPairTable:
        """The two-choice cuckoo pair table of the merge path."""
        if self._cuckoo_table is None:
            self._cuckoo_table = CuckooPairTable.build(self._ranks)
        return self._cuckoo_table

    def pair_table(self) -> PairTable:
        """The linear-probe pair table of the flat engine (ops/flat.py) and
        the bucket merge (ops/bpe.py ``merge_bucket_fn``)."""
        if self._pair_table is None:
            self._pair_table = PairTable.build(self._ranks)
        return self._pair_table

    def piece_table(self) -> CuckooPieceTable:
        """The whole-piece (poly-signature, length) -> rank cuckoo table of
        the flat engine's whole-piece fast path."""
        if self._piece_table is None:
            self._piece_table = CuckooPieceTable.build(self._ranks)
        return self._piece_table

    def word_map(self) -> WordDirectMap:
        """The word-exact whole-piece table: narrow (<= 12-byte tokens)
        unless the vocab holds a longer token, then wide (<= 24 bytes);
        either preference falls back to the other width if its build
        fails."""
        if self._word_map is None:
            max_tok = max((len(b) for b in self._ranks), default=1)
            first, second = (True, False) if max_tok > 12 else (False, True)
            try:
                self._word_map = WordDirectMap.build(self._ranks, wide=first)
            except InvalidConfigError:
                self._word_map = WordDirectMap.build(self._ranks, wide=second)
        return self._word_map

    def device_tables(self, device=None):
        """The encode tables on ``device`` (the tokenizer's by default),
        built and copied once per device."""
        from .tables import tables_from_numpy

        device = self._device if device is None else device
        key = str(device)
        tabs = self._device_tables.get(key)
        if tabs is None:
            table = self.cuckoo_table()
            wm = self.word_map()
            tabs = tables_from_numpy(table.packed, table.byte_pair_dense(),
                                     wm.rows, table.seed1, table.seed2,
                                     wm.seed, device)
            self._device_tables[key] = tabs
        return tabs
