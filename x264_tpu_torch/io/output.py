"""Output muxers (reference: output/output.h vtable; output/raw.c).

Raw Annex-B here; MP4/MKV/FLV in mux.py. open_output() selects by file
extension like the reference CLI (x264.c select_output, x264.c:1189).
"""

from __future__ import annotations

from ..entropy.nal import NAL, annexb_bytes


class RawOutput:
    """Raw .264 / .h264 Annex-B writer (reference: output/raw.c)."""

    def __init__(self, path) -> None:
        if hasattr(path, "write"):
            self._f = path
            self._own = False
        else:
            self._f = open(path, "wb")
            self._own = True
        self.bytes_written = 0

    def set_param(self, params) -> None:
        pass

    def write_headers(self, nals: list[NAL]) -> int:
        return self.write_frame(nals)

    def write_frame(self, nals: list[NAL], pts=None, dts=None) -> int:
        data = annexb_bytes(nals)
        self._f.write(data)
        self.bytes_written += len(data)
        return len(data)

    def close(self, largest_pts=None, second_largest_pts=None) -> None:
        if self._own:
            self._f.close()


def open_output(path: str, muxer: str | None = None):
    """Select a muxer by explicit name or output extension (reference
    select_output, x264.c:1189)."""
    from . import mux
    if muxer is None and isinstance(path, str):
        ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
        muxer = {"mp4": "mp4", "mov": "mp4", "mkv": "mkv",
                 "flv": "flv"}.get(ext, "raw")
    if muxer == "mp4":
        return mux.MP4Output(path)
    if muxer == "mkv":
        return mux.MKVOutput(path)
    if muxer == "flv":
        return mux.FLVOutput(path)
    return RawOutput(path)
