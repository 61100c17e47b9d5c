"""SQLite-backed catalog (the paper's prototype also uses SQLite).

Control-plane only: GOP payloads live as one object per GOP on disk
(``<root>/<logical>/<physical_id>/<index>.tvc``); the catalog stores the
physical-video metadata and the non-clustered temporal index (Figure 2),
plus the LRU clock and joint-compression records.

Thread-safe via a single connection + lock (VSS writes are streaming and
may race reads; SQLite serializes beneath us).
"""
from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.types import Box, GopMeta, PhysicalMeta, tile_keys

_SCHEMA = """
CREATE TABLE IF NOT EXISTS logical (
    name TEXT PRIMARY KEY,
    created REAL,
    budget_bytes INTEGER,           -- cache budget (§4)
    original_physical INTEGER
);
CREATE TABLE IF NOT EXISTS physical (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    logical TEXT NOT NULL,
    width INTEGER, height INTEGER, fps REAL,
    codec TEXT,
    roi_x0 INTEGER, roi_y0 INTEGER, roi_x1 INTEGER, roi_y1 INTEGER,
    t_start REAL, t_end REAL,
    mse_bound REAL,
    parent_is_original INTEGER,
    is_original INTEGER,
    created REAL,
    tiles_r INTEGER DEFAULT 1,      -- tiled layout: tile grid rows
    tiles_c INTEGER DEFAULT 1       -- tiled layout: tile grid cols
);
CREATE INDEX IF NOT EXISTS physical_logical ON physical(logical);
CREATE TABLE IF NOT EXISTS gop (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    physical_id INTEGER NOT NULL,
    idx INTEGER,
    start_frame INTEGER,
    num_frames INTEGER,
    nbytes INTEGER,
    path TEXT,
    zwrapped INTEGER DEFAULT 0,
    lru_seq INTEGER DEFAULT 0,
    joint_ref INTEGER,
    tile_sizes TEXT                 -- JSON per-tile byte sizes, row-major
);
CREATE INDEX IF NOT EXISTS gop_physical ON gop(physical_id, start_frame);
CREATE TABLE IF NOT EXISTS joint (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    gop_a INTEGER, gop_b INTEGER,
    merge TEXT,
    segments TEXT,                -- JSON list: homography + partition + paths
    g_scale REAL DEFAULT 1.0,     -- mixed-resolution upscale factor (§5.1.2)
    nbytes INTEGER,
    duplicate INTEGER DEFAULT 0   -- near-identity H: GOP b is a pointer to a
);
CREATE TABLE IF NOT EXISTS counters (name TEXT PRIMARY KEY, value INTEGER);
INSERT OR IGNORE INTO counters VALUES ('lru_clock', 0);
CREATE TABLE IF NOT EXISTS meta (name TEXT PRIMARY KEY, value TEXT);
"""


def _physical_from_row(r) -> PhysicalMeta:
    return PhysicalMeta(
        physical_id=r[0], logical=r[1], width=r[2], height=r[3], fps=r[4],
        codec=r[5], roi=(r[6], r[7], r[8], r[9]), t_start=r[10], t_end=r[11],
        mse_bound=r[12], parent_is_original=bool(r[13]),
        is_original=bool(r[14]), created=r[15],
        tiles=(r[16] or 1, r[17] or 1),
    )


_PHYS_COLS = (
    "id, logical, width, height, fps, codec, roi_x0, roi_y0, roi_x1, roi_y1,"
    " t_start, t_end, mse_bound, parent_is_original, is_original, created,"
    " tiles_r, tiles_c"
)


def _gop_from_row(r) -> GopMeta:
    return GopMeta(
        gop_id=r[0], physical_id=r[1], index=r[2], start_frame=r[3],
        num_frames=r[4], nbytes=r[5], path=r[6], zwrapped=bool(r[7]),
        lru_seq=r[8], joint_ref=r[9],
        tile_sizes=tuple(json.loads(r[10])) if r[10] else None,
    )


_GOP_COLS = (
    "id, physical_id, idx, start_frame, num_frames, nbytes, path, zwrapped,"
    " lru_seq, joint_ref, tile_sizes"
)

# columns added after the first shipped schema; CREATE TABLE IF NOT
# EXISTS won't grow an existing catalog, so each is applied as a
# best-effort ALTER (a duplicate-column error means already migrated)
_MIGRATIONS = (
    "ALTER TABLE physical ADD COLUMN tiles_r INTEGER DEFAULT 1",
    "ALTER TABLE physical ADD COLUMN tiles_c INTEGER DEFAULT 1",
    "ALTER TABLE gop ADD COLUMN tile_sizes TEXT",
)


class Catalog:
    def __init__(self, db_path: str):
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            for stmt in _MIGRATIONS:
                try:
                    self._conn.execute(stmt)
                except sqlite3.OperationalError:
                    pass  # column already exists
            self._conn.commit()

    # -- logical ---------------------------------------------------------
    def create_logical(self, name: str, budget_bytes: int) -> None:
        with self._lock:
            try:
                self._conn.execute(
                    "INSERT INTO logical(name, created, budget_bytes,"
                    " original_physical) VALUES (?,?,?,NULL)",
                    (name, time.time(), budget_bytes),
                )
            except sqlite3.IntegrityError:
                raise ValueError(
                    f"{name!r} already exists (no-overwrite policy)"
                ) from None
            self._conn.commit()

    def logical_exists(self, name: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM logical WHERE name=?", (name,)
            ).fetchone()
        return row is not None

    def list_logical(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute("SELECT name FROM logical").fetchall()
        return [r[0] for r in rows]

    def drop_logical(self, name: str) -> List[str]:
        """Delete a logical video and all its physical/GOP rows; returns
        the orphaned GOP object keys for the caller to delete from the
        storage backend.  Joint-compression records are dropped (and
        their segment object keys returned) only when no GOP outside
        this logical still references them — the partner side of a
        joint pair keeps reading through the shared pieces."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT g.id, g.path, g.joint_ref, p.tiles_r, p.tiles_c"
                " FROM gop g JOIN physical p"
                " ON g.physical_id = p.id WHERE p.logical=?",
                (name,),
            ).fetchall()
            dropped_ids = {r[0] for r in rows}
            # joint-ref GOPs own no object of their own (the payload
            # lives in the joint record's segment objects); tiled GOPs
            # own one object per tile
            paths = []
            for r in rows:
                if r[2] is not None:
                    continue
                tiles = (r[3] or 1, r[4] or 1)
                if tiles == (1, 1):
                    paths.append(r[1])
                else:
                    paths.extend(tile_keys(r[1], tiles))
            for jid in {r[2] for r in rows if r[2] is not None}:
                refs = {
                    r[0]
                    for r in self._conn.execute(
                        "SELECT id FROM gop WHERE joint_ref=?", (jid,)
                    ).fetchall()
                }
                if refs <= dropped_ids:  # last referent: free the pieces
                    segments = self._conn.execute(
                        "SELECT segments FROM joint WHERE id=?", (jid,)
                    ).fetchone()[0]
                    for seg in json.loads(segments or "[]"):
                        paths.extend(seg.get("paths", {}).values())
                    self._conn.execute("DELETE FROM joint WHERE id=?", (jid,))
            self._conn.execute(
                "DELETE FROM gop WHERE physical_id IN"
                " (SELECT id FROM physical WHERE logical=?)",
                (name,),
            )
            self._conn.execute("DELETE FROM physical WHERE logical=?", (name,))
            self._conn.execute("DELETE FROM logical WHERE name=?", (name,))
            self._conn.commit()
        return paths

    def drop_empty_logicals(self) -> List[str]:
        """Remove logical videos that index no data at all: rows with no
        physical videos (a crash between logical registration and the
        first flush in older stores) and logicals none of whose physicals
        holds a single GOP row (a crash — or a killed ingest pipeline —
        before the first publish window landed: the physical row was
        registered synchronously but every window was still queued, so
        nothing was ever indexed).  The startup scavenger calls this
        after the object-level scavenge.  Logicals whose pages were
        partially evicted are never touched here — budget eviction
        always preserves a lossless cover, so a live video always keeps
        at least one GOP row."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT name FROM logical WHERE name NOT IN ("
                " SELECT DISTINCT p.logical FROM physical p"
                " JOIN gop g ON g.physical_id = p.id)"
            ).fetchall()
            names = [r[0] for r in rows]
            if names:
                self._conn.executemany(
                    "DELETE FROM physical WHERE logical=?",
                    [(n,) for n in names],
                )
                self._conn.executemany(
                    "DELETE FROM logical WHERE name=?",
                    [(n,) for n in names],
                )
                self._conn.commit()
        return names

    def set_original(self, name: str, physical_id: int) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE logical SET original_physical=? WHERE name=?",
                (physical_id, name),
            )
            self._conn.commit()

    def get_budget(self, name: str) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT budget_bytes FROM logical WHERE name=?", (name,)
            ).fetchone()
        return row[0]

    def set_budget(self, name: str, budget_bytes: int) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE logical SET budget_bytes=? WHERE name=?",
                (budget_bytes, name),
            )
            self._conn.commit()

    def get_original_id(self, name: str) -> Optional[int]:
        with self._lock:
            row = self._conn.execute(
                "SELECT original_physical FROM logical WHERE name=?", (name,)
            ).fetchone()
        return row[0] if row else None

    # -- physical --------------------------------------------------------
    def add_physical(
        self, logical: str, width: int, height: int, fps: float, codec: str,
        roi: Box, t_start: float, t_end: float, mse_bound: float,
        parent_is_original: bool, is_original: bool,
        tiles: Tuple[int, int] = (1, 1),
    ) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO physical(logical, width, height, fps, codec,"
                " roi_x0, roi_y0, roi_x1, roi_y1, t_start, t_end, mse_bound,"
                " parent_is_original, is_original, created, tiles_r, tiles_c)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (logical, width, height, fps, codec, *roi, t_start, t_end,
                 mse_bound, int(parent_is_original), int(is_original),
                 time.time(), int(tiles[0]), int(tiles[1])),
            )
            self._conn.commit()
            return cur.lastrowid

    def get_physical(self, physical_id: int) -> PhysicalMeta:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {_PHYS_COLS} FROM physical WHERE id=?", (physical_id,)
            ).fetchone()
        if row is None:
            raise KeyError(f"physical {physical_id} not found")
        return _physical_from_row(row)

    def physicals_for(self, logical: str) -> List[PhysicalMeta]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {_PHYS_COLS} FROM physical WHERE logical=?",
                (logical,),
            ).fetchall()
        return [_physical_from_row(r) for r in rows]

    def extend_physical_time(self, physical_id: int, t_end: float) -> None:
        """Streaming writes push t_end forward as GOPs land (§2)."""
        with self._lock:
            self._conn.execute(
                "UPDATE physical SET t_end=MAX(t_end, ?) WHERE id=?",
                (t_end, physical_id),
            )
            self._conn.commit()

    def set_physical_bound(self, physical_id: int, mse_bound: float) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE physical SET mse_bound=? WHERE id=?",
                (mse_bound, physical_id),
            )
            self._conn.commit()

    def delete_physical(self, physical_id: int) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM gop WHERE physical_id=?",
                               (physical_id,))
            self._conn.execute("DELETE FROM physical WHERE id=?",
                               (physical_id,))
            self._conn.commit()

    # -- gops (temporal index) --------------------------------------------
    def add_gop(
        self, physical_id: int, index: int, start_frame: int,
        num_frames: int, nbytes: int, path: str, lru_seq: int = 0,
    ) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO gop(physical_id, idx, start_frame, num_frames,"
                " nbytes, path, lru_seq) VALUES (?,?,?,?,?,?,?)",
                (physical_id, index, start_frame, num_frames, nbytes, path,
                 lru_seq),
            )
            self._conn.commit()
            return cur.lastrowid

    def add_gops(
        self,
        rows: Sequence[Tuple[int, int, int, int, int, str, int]],
        *,
        return_ids: bool = True,
    ) -> List[int]:
        """Batch-insert GOP rows — one transaction, one commit — for the
        batched admission/ingest paths (`backend.batch_put` publishes the
        objects first; these rows index them afterwards).  Each row is
        (physical_id, index, start_frame, num_frames, nbytes, path,
        lru_seq) — with an optional 8th element, the JSON-encoded
        per-tile byte sizes for GOPs of a tiled physical video; returns
        the new GOP ids in order.  The ingest pipeline's publish windows
        pass ``return_ids=False`` to take the ``executemany`` fast path
        (one prepared statement for the whole window, no per-row id
        round-trip)."""
        norm = [
            tuple(r) if len(r) == 8 else tuple(r) + (None,) for r in rows
        ]
        with self._lock:
            if not return_ids:
                self._conn.executemany(
                    "INSERT INTO gop(physical_id, idx, start_frame,"
                    " num_frames, nbytes, path, lru_seq, tile_sizes)"
                    " VALUES (?,?,?,?,?,?,?,?)",
                    norm,
                )
                self._conn.commit()
                return []
            ids: List[int] = []
            for row in norm:
                cur = self._conn.execute(
                    "INSERT INTO gop(physical_id, idx, start_frame,"
                    " num_frames, nbytes, path, lru_seq, tile_sizes)"
                    " VALUES (?,?,?,?,?,?,?,?)",
                    row,
                )
                ids.append(cur.lastrowid)
            self._conn.commit()
        return ids

    def gops_for(self, physical_id: int) -> List[GopMeta]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {_GOP_COLS} FROM gop WHERE physical_id=?"
                " ORDER BY start_frame", (physical_id,),
            ).fetchall()
        return [_gop_from_row(r) for r in rows]

    def gops_in_range(
        self, physical_id: int, frame_start: int, frame_end: int
    ) -> List[GopMeta]:
        """Temporal-index lookup: GOPs overlapping [frame_start, frame_end)."""
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {_GOP_COLS} FROM gop WHERE physical_id=?"
                " AND start_frame < ? AND start_frame + num_frames > ?"
                " ORDER BY start_frame",
                (physical_id, frame_end, frame_start),
            ).fetchall()
        return [_gop_from_row(r) for r in rows]

    def get_gop(self, gop_id: int) -> GopMeta:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {_GOP_COLS} FROM gop WHERE id=?", (gop_id,)
            ).fetchone()
        if row is None:
            raise KeyError(f"gop {gop_id} not found")
        return _gop_from_row(row)

    def delete_gop(self, gop_id: int) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM gop WHERE id=?", (gop_id,))
            self._conn.commit()

    def update_gop(self, gop_id: int, **fields) -> None:
        cols = {"nbytes", "path", "zwrapped", "lru_seq", "joint_ref",
                "num_frames", "start_frame", "idx", "tile_sizes"}
        sets, vals = [], []
        for k, v in fields.items():
            if k not in cols:
                raise ValueError(f"bad gop field {k}")
            sets.append(f"{k}=?")
            vals.append(int(v) if isinstance(v, bool) else v)
        with self._lock:
            self._conn.execute(
                f"UPDATE gop SET {', '.join(sets)} WHERE id=?",
                (*vals, gop_id),
            )
            self._conn.commit()

    def touch_gops(self, gop_ids: Sequence[int]) -> int:
        """Bump the LRU clock and stamp the given GOPs; returns the tick."""
        if not gop_ids:
            return self.lru_clock()
        with self._lock:
            self._conn.execute(
                "UPDATE counters SET value = value + 1 WHERE name='lru_clock'"
            )
            tick = self._conn.execute(
                "SELECT value FROM counters WHERE name='lru_clock'"
            ).fetchone()[0]
            self._conn.executemany(
                "UPDATE gop SET lru_seq=? WHERE id=?",
                [(tick, g) for g in gop_ids],
            )
            self._conn.commit()
            return tick

    def lru_clock(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT value FROM counters WHERE name='lru_clock'"
            ).fetchone()[0]

    # -- store metadata (layout stamp, shutdown marker) --------------------
    def get_meta(self, name: str) -> Optional[str]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM meta WHERE name=?", (name,)
            ).fetchone()
        return row[0] if row else None

    def set_meta(self, name: str, value: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO meta(name, value) VALUES (?,?)"
                " ON CONFLICT(name) DO UPDATE SET value=excluded.value",
                (name, value),
            )
            self._conn.commit()

    def any_gops(self) -> bool:
        with self._lock:
            return self._conn.execute(
                "SELECT 1 FROM gop LIMIT 1"
            ).fetchone() is not None

    def all_physicals(self) -> List[PhysicalMeta]:
        """Every physical video across every logical (scavenger — it
        needs each GOP row's tile geometry to resolve object keys)."""
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {_PHYS_COLS} FROM physical"
            ).fetchall()
        return [_physical_from_row(r) for r in rows]

    def all_gops(self) -> List[GopMeta]:
        """Every GOP row across every logical video (startup scavenger)."""
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {_GOP_COLS} FROM gop ORDER BY id"
            ).fetchall()
        return [_gop_from_row(r) for r in rows]

    def all_joint_segment_paths(self) -> List[str]:
        """Object keys owned by joint-compression records (scavenger)."""
        with self._lock:
            rows = self._conn.execute("SELECT segments FROM joint").fetchall()
        out: List[str] = []
        for (segments,) in rows:
            for seg in json.loads(segments or "[]"):
                out.extend(seg.get("paths", {}).values())
        return out

    def lru_for_paths(self, paths: Sequence[str]) -> dict:
        """{object key: lru_seq} for the given keys — the hook that lets
        the tiered backend order hot-tier spill by LRU_VSS sequence
        numbers without owning any policy itself."""
        out: dict = {}
        if not paths:
            return out
        chunk = 500  # SQLite parameter limit headroom
        with self._lock:
            for i in range(0, len(paths), chunk):
                part = list(paths[i : i + chunk])
                marks = ",".join("?" * len(part))
                rows = self._conn.execute(
                    f"SELECT path, lru_seq FROM gop WHERE path IN ({marks})",
                    part,
                ).fetchall()
                out.update(rows)
        return out

    def spans_for_paths(self, paths: Sequence[str]) -> dict:
        """{object key: (logical, t_start, t_end)} for the given GOP
        keys — lets the adaptive tiering policy translate hot-tier
        object keys back into the video-time intervals the access
        profiler scores.  Keys the catalog doesn't know (joint
        segments, tile objects) are simply absent, mirroring
        `lru_for_paths`."""
        out: dict = {}
        if not paths:
            return out
        chunk = 500
        with self._lock:
            for i in range(0, len(paths), chunk):
                part = list(paths[i : i + chunk])
                marks = ",".join("?" * len(part))
                rows = self._conn.execute(
                    "SELECT g.path, p.logical, p.fps, p.t_start,"
                    " g.start_frame, g.num_frames"
                    " FROM gop g JOIN physical p ON g.physical_id = p.id"
                    f" WHERE g.path IN ({marks})",
                    part,
                ).fetchall()
                for path, logical, fps, t0, sf, nf in rows:
                    fps = fps or 1.0
                    out[path] = (
                        logical, t0 + sf / fps, t0 + (sf + nf) / fps
                    )
        return out

    def total_bytes(self, logical: str) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT COALESCE(SUM(g.nbytes), 0) FROM gop g JOIN physical p"
                " ON g.physical_id = p.id WHERE p.logical=?",
                (logical,),
            ).fetchone()
        return row[0]

    # -- joint compression records (§5.1) ---------------------------------
    def add_joint(
        self, gop_a: int, gop_b: int, merge: str, segments,
        nbytes: int, duplicate: bool = False, g_scale: float = 1.0,
    ) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO joint(gop_a, gop_b, merge, segments, g_scale,"
                " nbytes, duplicate) VALUES (?,?,?,?,?,?,?)",
                (gop_a, gop_b, merge, json.dumps(segments), g_scale, nbytes,
                 int(duplicate)),
            )
            self._conn.commit()
            return cur.lastrowid

    def get_joint(self, joint_id: int):
        with self._lock:
            row = self._conn.execute(
                "SELECT id, gop_a, gop_b, merge, segments, g_scale, nbytes,"
                " duplicate FROM joint WHERE id=?", (joint_id,),
            ).fetchone()
        if row is None:
            raise KeyError(f"joint {joint_id} not found")
        return {
            "id": row[0], "gop_a": row[1], "gop_b": row[2], "merge": row[3],
            "segments": json.loads(row[4]), "g_scale": row[5],
            "nbytes": row[6], "duplicate": bool(row[7]),
        }

    def gops_with_joint_ref(self, joint_id: int) -> List[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id FROM gop WHERE joint_ref=?", (joint_id,)
            ).fetchall()
        return [r[0] for r in rows]

    def close(self) -> None:
        with self._lock:
            self._conn.close()
