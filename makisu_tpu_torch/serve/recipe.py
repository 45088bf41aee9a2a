"""Layer recipes: the distribution plane's unit of metadata.

Copy of ``makisu_tpu/serve/recipe.py``, with the reference's recipe
schema, canonical body, HMAC, pack tables and seekable-zstd twins, so a
recipe or a pack table written by either package is byte for byte the
other's. The chunk triples a recipe names are the ones the gpu hasher's
G1 and S1 kernels produced at commit; publishing reads the chunks back
from the CAS and checks each against its name with hashlib.

A **recipe** is the ordered ``(chunk fingerprint, length, pack hex,
pack offset)`` table for one built layer, plus the layer's identity
(tar digest, gzip digest, size, gzip backend id). A chunk-aware client
holding some of the chunks fetches only the missing spans of the
referenced packs and reconstitutes the layer byte-identically — the
delta-pull economics of chunk dedup (arxiv 2508.05797) applied to
*serving*, with the bounded-memory ranged machinery of arxiv
2607.05596 on the wire.

Recipes are **signed**: the canonical body is self-digested always, and
HMAC-SHA256 signed when ``MAKISU_TPU_SERVE_KEY`` is configured. A
client configured with the key refuses unsigned or wrongly-signed
recipes — a recipe tells the client which bytes to assemble into a
blob it will trust under a registry digest, so its integrity must not
rest on the transport alone. (The final safety net is unconditional
either way: every carved chunk is digest-verified and the
reconstituted layer must match the registry digest byte-for-byte
before install.)

The **pack member table** (``[(fingerprint, length), ...]`` per pack
hex) is the serving side's other artifact: packs are *synthesized* from
the chunk CAS on demand — a pack's bytes are the concatenation of its
members — so the store never keeps pack blobs resident; serving a
range costs reads of only the overlapped chunks.

**Seekable-zstd packs**: alongside each new pack, publish writes a
compressed twin — the pack's bytes re-encoded as independently-
decompressible zstd frames (frame boundaries on chunk boundaries,
~``pack_frame_target_bytes()`` of raw bytes per frame) persisted under
``zpacks/<pack_hex>.zst`` — and a **frame index**
(``[raw_off, raw_len, z_off, z_len]`` rows) recorded in the pack table
and embedded in every referencing recipe (``zpacks`` key). A
frame-aware client maps missing chunk spans to frame ranges and pulls
*compressed* bytes over ``GET /zpacks/<hex>`` Range requests, each
frame decompressing without upstream context; clients or servers
without the capability (no libzstd, old peer, pre-frame pack) simply
keep the raw ``/packs`` wire — negotiation is by presence, never a
hard break. Frames are an encoding of pack bytes, not an identity:
pack hexes still name the RAW concatenation, and every carved chunk is
sha256-verified before the CAS stores it, so a lying frame can waste
bytes, never install bytes.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import os
import threading

from makisu_tpu_torch.utils import fileio
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

RECIPE_SCHEMA = "makisu-tpu.recipe.v1"

_HEX = set("0123456789abcdef")


def is_hex_digest(name: str) -> bool:
    """Full lowercase-hex sha256 check — recipe/pack names become file
    paths, so validation happens before any path machinery."""
    return len(name) == 64 and all(c in _HEX for c in name)


def signing_key() -> bytes:
    """The serve plane's shared HMAC key (``MAKISU_TPU_SERVE_KEY``);
    empty means unsigned recipes (self-digest integrity only)."""
    return os.environ.get("MAKISU_TPU_SERVE_KEY", "").encode()


def pack_frame_target_bytes() -> int:
    """Raw bytes per seekable-pack frame (MAKISU_TPU_PACK_FRAME_KB,
    default 256KiB): small enough that a scattered 1-edit delta
    over-decompresses little, large enough that zstd's ratio doesn't
    collapse to per-chunk framing. Floored at 16KiB — below the
    average chunk size the frame table would outgrow its savings."""
    try:
        target = int(float(os.environ.get(
            "MAKISU_TPU_PACK_FRAME_KB", "256")) * 1024)
    except ValueError:
        return 256 * 1024
    return max(target, 16 * 1024)


def _frame_rows_valid(frames) -> bool:
    """Structural check for one pack's frame-index rows."""
    if not isinstance(frames, list) or not frames:
        return False
    for row in frames:
        if not (isinstance(row, list) and len(row) == 4):
            return False
        raw_off, raw_len, z_off, z_len = row
        for v in (raw_off, raw_len, z_off, z_len):
            if not isinstance(v, int) or v < 0:
                return False
        if raw_len <= 0 or z_len <= 0:
            return False
    return True


def canonical_body(doc: dict) -> bytes:
    """The byte string the digest/signature cover: every field except
    the digest/signature themselves, canonically serialized."""
    body = {k: v for k, v in doc.items() if k not in ("digest", "sig")}
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


def seal(doc: dict, key: bytes | None = None) -> dict:
    """Stamp the self-digest and (when a key is configured) the HMAC
    signature onto a recipe document. Returns the same dict."""
    key = signing_key() if key is None else key
    body = canonical_body(doc)
    doc["digest"] = hashlib.sha256(body).hexdigest()
    doc["sig"] = (hmac_mod.new(key, body, "sha256").hexdigest()
                  if key else "")
    return doc


def well_formed(doc: dict) -> bool:
    """Structural check: the exact shape every consumer indexes into
    (`doc["layer"]["gzip"]`, 4-element chunk rows). A sealed-but-
    malformed document must be a MISS (degrade to the blob route),
    never a KeyError inside a pull or a peer fetch."""
    layer = doc.get("layer")
    if not isinstance(layer, dict):
        return False
    if not is_hex_digest(str(layer.get("tar", ""))) \
            or not is_hex_digest(str(layer.get("gzip", ""))):
        return False
    if not isinstance(layer.get("size"), int) or layer["size"] < 0:
        return False
    rows = doc.get("chunks")
    if not isinstance(rows, list):
        return False
    for row in rows:
        if not (isinstance(row, list) and len(row) == 4):
            return False
        fp, length, pack_hex, pack_off = row
        if not is_hex_digest(str(fp)) \
                or not is_hex_digest(str(pack_hex)):
            return False
        if not isinstance(length, int) or length <= 0:
            return False
        if not isinstance(pack_off, int) or pack_off < 0:
            return False
    packs = doc.get("packs")
    if packs is not None:
        # Optional (absent in early recipes): the referenced packs'
        # TRUE sizes, so the client's whole-pack crossover uses the
        # same denominator as the registry path instead of the extent
        # this one recipe happens to reference.
        if not isinstance(packs, dict):
            return False
        for pack_hex, size in packs.items():
            if not is_hex_digest(str(pack_hex)) \
                    or not isinstance(size, int) or size <= 0:
                return False
    zpacks = doc.get("zpacks")
    if zpacks is not None:
        # Optional (absent pre-seekable or when libzstd was missing at
        # publish): per-pack frame indexes for the compressed wire.
        if not isinstance(zpacks, dict):
            return False
        for pack_hex, frames in zpacks.items():
            if not is_hex_digest(str(pack_hex)) \
                    or not _frame_rows_valid(frames):
                return False
    return True


def verify(doc: dict, key: bytes | None = None) -> bool:
    """Integrity check a consumer runs before trusting a recipe: the
    document must be structurally well-formed, the self-digest must
    match the canonical body, and when THIS process holds a key, the
    HMAC must verify — an unsigned recipe is refused by a keyed client
    (a keyless client accepts unsigned recipes; it has nothing to
    verify a signature against)."""
    if doc.get("schema") != RECIPE_SCHEMA:
        return False
    if not well_formed(doc):
        return False
    body = canonical_body(doc)
    if doc.get("digest") != hashlib.sha256(body).hexdigest():
        return False
    key = signing_key() if key is None else key
    if key:
        want = hmac_mod.new(key, body, "sha256").hexdigest()
        return hmac_mod.compare_digest(doc.get("sig") or "", want)
    return True


def stream_triples(rows: list) -> list[tuple[int, int, str]]:
    """Recipe rows → the ``(stream offset, length, fingerprint)``
    triples the chunk CAS APIs speak. Chunks tile the uncompressed
    stream, so offsets are the running sum of lengths — the recipe
    doesn't repeat them on the wire."""
    triples = []
    pos = 0
    for fp, length, _pack, _off in rows:
        triples.append((pos, int(length), fp))
        pos += int(length)
    return triples


class RecipeStore:
    """On-disk recipe + pack-member store under ``<storage>/serve/``.

    Layout: ``recipes/<layer_hex>.json`` (sealed recipe documents) and
    ``packs/<pack_hex>.json`` (member tables). A process-wide chunk
    index (fingerprint → pack coordinates) backs publish-time dedup:
    a chunk already mapped to a pack keeps that mapping in every later
    layer's recipe, so yesterday's chunks stay in yesterday's packs and
    a delta client fetches only the new packs' spans."""

    def __init__(self, root: str, chunk_root: str) -> None:
        self.root = root
        self.chunk_root = os.path.realpath(chunk_root)
        self._recipes_dir = os.path.join(root, "recipes")
        self._packs_dir = os.path.join(root, "packs")
        self._zpacks_dir = os.path.join(root, "zpacks")
        self._mu = threading.Lock()
        self._chunk_index: dict[str, tuple[str, int, int]] = {}
        self._pack_members: dict[str, list[tuple[str, int]]] = {}
        self._pack_sizes: dict[str, int] = {}
        # Seekable twin: per-pack frame index rows
        # (raw_off, raw_len, z_off, z_len) describing zpacks/<hex>.zst.
        self._pack_frames: dict[str, list[list[int]]] = {}
        self._loaded = False

    # -- persistence ------------------------------------------------------

    @staticmethod
    def _parse_pack_table(doc):
        """Both pack-table shapes: the legacy bare member list, and the
        dict form that adds the seekable frame index. Returns
        ``(members, frames_or_None)``; raises on malformed input (the
        caller treats that as "pack not served")."""
        if isinstance(doc, dict):
            members = [(str(fp), int(length))
                       for fp, length in doc["members"]]
            frames = doc.get("frames")
            if frames is not None:
                # A malformed frame index demotes the pack to
                # raw-only serving — it must never take the intact
                # member table down with it.
                try:
                    frames = [[int(v) for v in row] for row in frames]
                except (TypeError, ValueError):
                    frames = None
                else:
                    if not _frame_rows_valid(frames):
                        frames = None
            return members, frames
        return [(str(fp), int(length)) for fp, length in doc], None

    def _load_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            names = os.listdir(self._packs_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            pack_hex = name[:-len(".json")]
            if not is_hex_digest(pack_hex):
                continue
            try:
                with open(os.path.join(self._packs_dir, name),
                          encoding="utf-8") as f:
                    members, frames = self._parse_pack_table(
                        json.load(f))
            except (OSError, ValueError, TypeError, KeyError):
                continue  # torn/corrupt table: pack simply not served
            self._index_pack_locked(pack_hex, members, frames)

    def _index_pack_locked(self, pack_hex: str,
                           members: list[tuple[str, int]],
                           frames=None) -> None:
        self._pack_members[pack_hex] = members
        off = 0
        for fp, length in members:
            self._chunk_index.setdefault(fp, (pack_hex, off, length))
            off += length
        self._pack_sizes[pack_hex] = off
        if frames:
            self._pack_frames[pack_hex] = [
                [int(v) for v in row] for row in frames]

    # -- publish ----------------------------------------------------------

    @staticmethod
    def _encode_frames(raw: bytes, members: list[tuple[str, int]]
                       ) -> tuple[list[list[int]] | None, bytes | None]:
        """Encode one pack's raw bytes as independent zstd frames with
        boundaries on chunk boundaries (~pack_frame_target_bytes() of
        raw bytes each — whole chunks, so any chunk decompresses from
        exactly one frame). Returns ``(frame_rows, zblob)`` or
        ``(None, None)`` when libzstd is unavailable (the pack serves
        raw-only; never a publish failure)."""
        from makisu_tpu_torch.utils import zstdio
        if not zstdio.available():
            return None, None
        target = pack_frame_target_bytes()
        frames: list[list[int]] = []
        zparts: list[bytes] = []
        raw_off = z_off = 0
        frame_len = 0
        for _, length in members:
            frame_len += length
            if frame_len >= target:
                z = zstdio.compress(
                    raw[raw_off:raw_off + frame_len])
                frames.append([raw_off, frame_len, z_off, len(z)])
                zparts.append(z)
                raw_off += frame_len
                z_off += len(z)
                frame_len = 0
        if frame_len:
            z = zstdio.compress(raw[raw_off:raw_off + frame_len])
            frames.append([raw_off, frame_len, z_off, len(z)])
            zparts.append(z)
        if not frames:
            return None, None
        return frames, b"".join(zparts)

    def publish(self, pair, triples: list[tuple[int, int, str]],
                gz_backend: str | None, chunk_store) -> dict | None:
        """Publish one built layer: assign every chunk a pack
        coordinate (reusing existing mappings; grouping novel chunks
        into new packs read back from ``chunk_store``), persist the
        pack tables + the sealed recipe. Returns the recipe document,
        or None when a chunk's bytes are not in the CAS (the layer
        simply isn't serveable; the blob route still is)."""
        layer_hex = pair.gzip_descriptor.digest.hex()
        from makisu_tpu_torch.cache.chunks import pack_target_bytes
        target = pack_target_bytes()
        # Phase 1 (lock): validate the chunk tiling and plan which
        # fingerprints are novel. Cheap, in-memory.
        with self._mu:
            self._load_locked()
            pos = 0
            seen: set[str] = set()
            novel: list[tuple[str, int]] = []
            for offset, length, fp in triples:
                if offset != pos:
                    log.warning("recipe for %s refused: chunk list has "
                                "a gap at %d (expected %d)", layer_hex,
                                offset, pos)
                    return None
                pos = offset + length
                if fp in self._chunk_index or fp in seen:
                    continue
                seen.add(fp)
                novel.append((fp, int(length)))
        # Phase 2 (NO lock): read the novel chunks' bytes back out of
        # the CAS and group them into packs. This is the expensive
        # pass (gigabytes on a cold large layer) — pack serving must
        # not stall behind it. Pack tables persist before anything
        # references them.
        new_packs: list[tuple[str, list[tuple[str, int]],
                              list[list[int]] | None]] = []
        buf = bytearray()
        members: list[tuple[str, int]] = []

        def flush() -> None:
            nonlocal buf, members
            if not members:
                return
            raw = bytes(buf)
            pack_hex = hashlib.sha256(raw).hexdigest()
            frames, zblob = self._encode_frames(raw, members)
            if zblob is not None:
                os.makedirs(self._zpacks_dir, exist_ok=True)
                # Frame bytes land BEFORE the table that indexes them:
                # a reader may see a zpack with no table (unused), but
                # never a table pointing at a missing/torn file.
                fileio.write_bytes_atomic(
                    os.path.join(self._zpacks_dir, f"{pack_hex}.zst"),
                    zblob)
            new_packs.append((pack_hex, list(members), frames))
            buf = bytearray()
            members = []

        for fp, length in novel:
            try:
                data = chunk_store.get(fp)
            except (OSError, ValueError):
                log.info("recipe for %s not published: chunk %s "
                         "not in the local CAS", layer_hex, fp)
                return None
            if len(data) != length:
                log.warning("recipe for %s refused: chunk %s CAS "
                            "size %d != recorded %d", layer_hex,
                            fp, len(data), length)
                return None
            buf += data
            members.append((fp, length))
            if len(buf) >= target:
                flush()
        flush()
        if new_packs:
            os.makedirs(self._packs_dir, exist_ok=True)
            for pack_hex, pack_members, frames in new_packs:
                rows_out = [[fp, length] for fp, length in pack_members]
                # Legacy bare-list shape when no frames (old readers
                # parse it); dict shape carries the frame index.
                table = ({"members": rows_out, "frames": frames}
                         if frames else rows_out)
                fileio.write_json_atomic(
                    os.path.join(self._packs_dir, f"{pack_hex}.json"),
                    table)
        # Phase 3 (lock): index the new packs and resolve every row.
        # A racing publish may have indexed some of our "novel"
        # chunks into its own pack meanwhile — setdefault keeps the
        # first mapping, so rows stay consistent with what the index
        # serves (our duplicate pack is still servable; just unused
        # by this recipe).
        rows: list[list] = []
        pack_sizes: dict[str, int] = {}
        zpacks: dict[str, list] = {}
        with self._mu:
            for pack_hex, pack_members, frames in new_packs:
                self._index_pack_locked(pack_hex, pack_members, frames)
            for _, length, fp in triples:
                coords = self._chunk_index.get(fp)
                if coords is None:
                    return None  # unreachable; defensive
                rows.append([fp, int(length), coords[0], coords[1]])
                size = self._pack_sizes.get(coords[0], 0)
                if size > 0:
                    pack_sizes[coords[0]] = size
                frames = self._pack_frames.get(coords[0])
                if frames:
                    zpacks[coords[0]] = frames
        doc = seal({
            "schema": RECIPE_SCHEMA,
            "layer": {
                "tar": pair.tar_digest.hex(),
                "gzip": layer_hex,
                "size": pair.gzip_descriptor.size,
                "gz": gz_backend or "",
            },
            "chunks": rows,
            # True sizes of every referenced pack: a layer may touch
            # only a sliver of a pack shared with other layers, and
            # the client's runs-vs-whole decision must be made against
            # the real pack size (the registry path feeds the planner
            # exact sizes from the member tables).
            "packs": pack_sizes,
            # Frame indexes of every referenced pack that has a
            # seekable twin: the client's capability signal AND its
            # span→frame map — absent entries (old packs, libzstd-less
            # publishers) keep those packs on the raw wire.
            "zpacks": zpacks,
        })
        os.makedirs(self._recipes_dir, exist_ok=True)
        fileio.write_json_atomic(
            os.path.join(self._recipes_dir, f"{layer_hex}.json"),
            doc)
        metrics.counter_add(metrics.SERVE_RECIPES_PUBLISHED)
        log.info("published serve recipe for %s (%d chunks, %d new "
                 "pack(s))", layer_hex, len(rows), len(new_packs))
        return doc

    # -- serving reads ----------------------------------------------------

    def recipe(self, layer_hex: str) -> dict | None:
        if not is_hex_digest(layer_hex):
            return None
        try:
            with open(os.path.join(self._recipes_dir,
                                   f"{layer_hex}.json"),
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _refresh_pack_locked(self, pack_hex: str) -> None:
        """Pick up a pack table published by ANOTHER process since
        this store loaded — the standalone `serve` shape
        has builders appending to the storage it serves, and a miss
        on an unknown pack must cost one file probe, not a permanent
        404 until restart."""
        if pack_hex in self._pack_members:
            return
        try:
            with open(os.path.join(self._packs_dir,
                                   f"{pack_hex}.json"),
                      encoding="utf-8") as f:
                members, frames = self._parse_pack_table(json.load(f))
        except (OSError, ValueError, TypeError, KeyError):
            return
        self._index_pack_locked(pack_hex, members, frames)

    def pack_members(self, pack_hex: str) -> list | None:
        if not is_hex_digest(pack_hex):
            return None
        with self._mu:
            self._load_locked()
            self._refresh_pack_locked(pack_hex)
            return self._pack_members.get(pack_hex)

    def pack_size(self, pack_hex: str) -> int:
        with self._mu:
            self._load_locked()
            self._refresh_pack_locked(pack_hex)
            return self._pack_sizes.get(pack_hex, 0)

    def pack_frames(self, pack_hex: str) -> list | None:
        """The seekable frame index for ``pack_hex``, or None when the
        pack has no compressed twin (pre-frame pack, libzstd-less
        publisher)."""
        if not is_hex_digest(pack_hex):
            return None
        with self._mu:
            self._load_locked()
            self._refresh_pack_locked(pack_hex)
            return self._pack_frames.get(pack_hex)

    def zpack_size(self, pack_hex: str) -> int:
        """Total compressed size of the pack's frame file (the Range
        denominator for ``/zpacks``); 0 when no frames."""
        frames = self.pack_frames(pack_hex)
        if not frames:
            return 0
        last = frames[-1]
        return int(last[2]) + int(last[3])

    def iter_zpack_range(self, pack_hex: str, start: int, end: int,
                         piece_size: int = 1 << 20):
        """Yield bytes ``[start, end)`` of the pack's compressed frame
        file in bounded pieces. Raises ``FileNotFoundError`` when the
        file is gone and ``ValueError`` when it is shorter than the
        frame index promises (both degrade the request to a 404/closed
        stream, and the client to the raw or blob route)."""
        path = os.path.join(self._zpacks_dir, f"{pack_hex}.zst")
        with open(path, "rb") as fh:
            if start:
                fh.seek(start)
            remaining = end - start
            while remaining > 0:
                piece = fh.read(min(remaining, piece_size))
                if not piece:
                    raise ValueError(
                        f"zpack {pack_hex} shorter than its frame "
                        f"index")
                remaining -= len(piece)
                yield piece

    def stats(self) -> dict:
        """Digest for /healthz: how much this store can serve."""
        recipes = 0
        try:
            recipes = sum(1 for n in os.listdir(self._recipes_dir)
                          if n.endswith(".json"))
        except OSError:
            pass
        # Index packs published by other processes since load, so the
        # capacity signal counts them without waiting for a client to
        # miss on each (recipes come from listdir above; packs must
        # match that freshness or the section reads recipes>0/packs=0).
        try:
            on_disk = [n[:-len(".json")]
                       for n in os.listdir(self._packs_dir)
                       if n.endswith(".json")
                       and is_hex_digest(n[:-len(".json")])]
        except OSError:
            on_disk = []
        with self._mu:
            self._load_locked()
            for pack_hex in on_disk:
                self._refresh_pack_locked(pack_hex)
            return {
                "recipes": recipes,
                "packs": len(self._pack_members),
                "pack_bytes": sum(self._pack_sizes.values()),
                "zpacks": len(self._pack_frames),
            }

    def iter_pack_range(self, pack_hex: str, start: int, end: int,
                        piece_size: int = 1 << 20):
        """Yield the bytes of pack ``pack_hex`` in ``[start, end)`` as
        bounded pieces, synthesized from member chunks in the chunk
        CAS — no pack blob is ever materialized. A member the budget
        evictor demoted comes back from its pack tier first; raises
        ``FileNotFoundError`` when a member cannot be had (the endpoint
        answers 404; the client degrades to the blob route)."""
        members = self.pack_members(pack_hex)
        if members is None:
            raise FileNotFoundError(pack_hex)
        from makisu_tpu_torch.cache import chunks as chunks_mod
        from makisu_tpu_torch.storage import contentstore
        board = contentstore.board_for_chunk_root(self.chunk_root)
        off = 0
        for fp, length in members:
            if off + length <= start:
                off += length
                continue
            if off >= end:
                return
            lo = max(start - off, 0)
            hi = min(end - off, length)
            # Pin across the member read: a peer-serve range in flight
            # must never lose its chunk to an eviction pass.
            with board.pinned("chunks", fp):
                fh = chunks_mod.open_served_chunk(
                    fp, roots={self.chunk_root})
                if fh is None:
                    # Demoted by a budget eviction pass: refetch it from
                    # the pack or remote tier before giving up.
                    restored = contentstore.refetch_for_chunk_root(
                        self.chunk_root, [fp], {fp: length})
                    if fp in restored:
                        fh = chunks_mod.open_served_chunk(
                            fp, roots={self.chunk_root})
                if fh is None:
                    raise FileNotFoundError(fp)
                with fh:
                    if lo:
                        fh.seek(lo)
                    remaining = hi - lo
                    while remaining > 0:
                        piece = fh.read(min(remaining, piece_size))
                        if not piece:
                            raise ValueError(
                                f"chunk {fp} shorter than its "
                                f"recorded length")
                        remaining -= len(piece)
                        yield piece
            off += length
