"""The benchmark's plain reference: an H.264 decoder in NumPy.

`decoder.py` is a frozen copy of the repository's spec decoder
(tools/refdec.py, written from ITU-T H.264 clauses 7-9), changed only to
import its tables from this folder, to decode a stream from the middle
(`Decoder.seed`, `decode_nal`, `slice_header_start`, `poc_step`), to keep
each picture's uncropped planes and slice QP, and to filter the MBs of
one wavefront together (`deblock_frame_ref`, held equal to the scalar
`deblock_frame_scalar` by portbench/tests). Its spec tables are its own
copies:

- `vlc_tables.py`: CAVLC tables 9-5 (coeff_token), 9-7/9-8/9-9
  (total_zeros), 9-10 (run_before) and 9-4 (coded_block_pattern mapping),
  copied from x264_tpu/entropy/vlc_tables.py.
- `cabac_tables.py`: CABAC tables 9-12..9-33 (context initialisation),
  9-44 (rangeTabLPS) and 9-45 (state transitions), copied from
  x264_tpu/entropy/cabac_tables.py.

Nothing here imports jax, x264_tpu or x264_tpu_torch.
"""
