"""Input generators of the benchmark: frozen copies of ``chip_smoke.py``'s
context generators, so that a later change to the smoke or to the
program never moves the yardstick. Each function names the lines it was
copied from; only the module-level constants became arguments.

Every generator is a pure function of its arguments: the same seed gives
the same paths and bytes.
"""

from __future__ import annotations

import os

import numpy as np

MIB = 1 << 20

# One fixed modification time for every generated context file and
# directory (2020-09-13T12:26:40Z): a build context is a checkout whose
# files are older than the build, and a fixed time keeps the layer tar's
# headers, and so its digests, a function of the seed alone.
CONTEXT_MTIME = 1_600_000_000


def layer_files(target: int, seed: int):
    """(name, content) of a deterministic app of about ``target`` tar
    bytes shaped like a node_modules-heavy app: small text-like files
    (log-uniform 1-64 KiB, one in seven repeating an earlier file) until
    ~75% of the target, then random-byte binaries of 4-16 MiB.

    Copied from ``chip_smoke.py:803-837`` (``layer_files``)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, size=int(k))])
             for k in rng.integers(2, 10, size=4000)]
    vocab += [b"function", b"return", b"const", b"require(", b"});\n",
              b"module.exports", b"=>", b"{\n", b"\n"]
    pick = np.minimum(rng.zipf(1.3, size=(8 * MIB) // 5), len(vocab)) - 1
    pool = b" ".join(vocab[i] for i in pick.tolist())
    total = 0  # tar bytes so far: a header and the padded content each
    texts = []  # (pool offset, size) of each text file, for repeats
    k = 0
    while total < 0.75 * target:
        if len(texts) > 8 and rng.random() < 1 / 7:
            at, size = texts[int(rng.integers(0, len(texts)))]
        else:
            size = int(np.exp(rng.uniform(np.log(1024), np.log(65536))))
            at = int(rng.integers(0, len(pool) - size))
            texts.append((at, size))
        yield (f"app/node_modules/pkg{k // 40:04d}/lib/f{k:05d}.js",
               pool[at:at + size])
        total += 512 + -(-size // 512) * 512
        k += 1
    b = 0
    while total < target:
        size = min(int(rng.integers(4 * MIB, 16 * MIB)),
                   max(target - total, 1))
        yield (f"app/bin/blob{b:03d}.bin",
               rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
        total += 512 + -(-size // 512) * 512
        b += 1


def dist_files(target: int, seed: int, services: int):
    """(path, content) of a monorepo of about ``target`` bytes in
    ``services`` top-level service directories, BASELINE.md config 4's
    ratio of 100k files to 10 GB: files of 4-192 KiB (mean ~100 KiB),
    four in five text-like (letters, spaces, newlines, braces), the rest
    random bytes. Paths are unique across services, so a COPY of two
    service directories into one destination keeps every file.

    Copied from ``chip_smoke.py:2962-2985`` (``dist_files``; its
    ``DIST_SERVICES`` is ``services`` here)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    \n\n{}();=.",
                             dtype=np.uint8)
    total = 0
    i = 0
    while total < target:
        svc = i % services
        size = int(rng.integers(4 << 10, (192 << 10) + 1))
        if rng.random() < 0.8:
            content = alphabet[rng.integers(0, len(alphabet), size)].tobytes()
            ext = "ts"
        else:
            content = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            ext = "bin"
        yield (f"svc{svc}/pkg{svc}{i // 400:03d}/f{i:05d}.{ext}", content)
        total += size
        i += 1


def dist_dockerfile(services: int) -> str:
    """Four COPY steps, two service directories each, every step
    committed (``--commit explicit``): four layers.

    Copied from ``chip_smoke.py:2988-2993`` (``dist_dockerfile``)."""
    return "FROM scratch\n" + "".join(
        f"COPY svc{2 * k} svc{2 * k + 1} /srv/ #!COMMIT\n"
        for k in range(services // 2))


EDIT_BYTES = b"/* fleet edit */"[:16]


def pick_one_percent(paths: list[str], seed) -> list[str]:
    """The files that ``append_to_one_percent`` edits: 1% of ``paths``
    (sorted, at least one), chosen by a seeded rng.

    Copied from ``chip_smoke.py:3783-3794`` (``append_to_one_percent``),
    split so that the reference can replay the picks without the disk."""
    rng = np.random.default_rng(seed)
    picked = rng.choice(len(paths), size=max(1, len(paths) // 100),
                        replace=False)
    return [paths[i] for i in picked.tolist()]


def append_to_one_percent(ctx: str, seed) -> list[str]:
    """Append 16 bytes to 1% of the files under ``ctx`` (at least one),
    chosen by a seeded rng; a Dockerfile stays as it is. Returns the
    paths edited, relative to ``ctx``.

    Copied from ``chip_smoke.py:3783-3794`` (``append_to_one_percent``)."""
    paths = sorted(os.path.relpath(os.path.join(d, n), ctx)
                   for d, _, names in os.walk(ctx)
                   for n in names if n != "Dockerfile")
    picked = pick_one_percent(paths, seed)
    for rel in picked:
        with open(os.path.join(ctx, rel), "ab") as f:
            f.write(EDIT_BYTES)
    return picked


GENERATORS = {"layer_files": lambda cfg, seed: layer_files(
                  cfg["context_bytes"], seed),
              "dist_files": lambda cfg, seed: dist_files(
                  cfg["context_bytes"], seed, cfg["services"])}
DOCKERFILES = {"dist_dockerfile": lambda cfg: dist_dockerfile(
                   cfg["services"])}


def _group(path: str) -> tuple[str, str]:
    """A file's group: its top directory and its extension."""
    return path.split("/", 1)[0], path.rsplit(".", 1)[-1]


def context_files(cfg: dict, seed: int) -> list[tuple[str, bytes]]:
    """The (path, content) pairs of configuration ``cfg``'s context.

    The files come from the generator at the configuration's own
    ``shape_seed``, so every seed gets the same set of paths and
    contents, and so the same work; ``seed`` then deals the contents out
    among the paths of each group (top directory and extension), so each
    seed's layer stream, and every cut and digest in it, differs."""
    files = list(GENERATORS[cfg["generator"]](cfg, cfg["shape_seed"]))
    rng = np.random.default_rng(seed)
    groups: dict[tuple, list[int]] = {}
    for k, (path, _) in enumerate(files):
        groups.setdefault(_group(path), []).append(k)
    out = list(files)
    for members in groups.values():
        for k, j in zip(members, rng.permutation(members).tolist()):
            out[k] = (files[k][0], files[j][1])
    return out


def dockerfile(cfg: dict) -> str:
    """The configuration's Dockerfile: its text, or a named generator's."""
    text = cfg["dockerfile"]
    return DOCKERFILES[text](cfg) if text in DOCKERFILES else text


def write_context(path: str, files, dockerfile_text: str) -> tuple[int, int]:
    """Write the files and the Dockerfile under ``path`` and set every
    file's and directory's times to CONTEXT_MTIME. Returns (files,
    bytes)."""
    nfiles = nbytes = 0
    dirs = {path}
    for name, content in files:
        dst = os.path.join(path, name)
        parent = os.path.dirname(dst)
        if parent not in dirs:
            os.makedirs(parent, exist_ok=True)
            while parent not in dirs:
                dirs.add(parent)
                parent = os.path.dirname(parent)
        with open(dst, "wb") as f:
            f.write(content)
        os.utime(dst, (CONTEXT_MTIME, CONTEXT_MTIME))
        nfiles += 1
        nbytes += len(content)
    with open(os.path.join(path, "Dockerfile"), "w") as f:
        f.write(dockerfile_text)
    os.utime(os.path.join(path, "Dockerfile"), (CONTEXT_MTIME, CONTEXT_MTIME))
    for d in sorted(dirs, key=len, reverse=True):
        os.utime(d, (CONTEXT_MTIME, CONTEXT_MTIME))
    return nfiles, nbytes
