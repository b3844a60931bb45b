"""Host milliseconds a window inside the program's ``ingest_copy`` spans:
``run_epoch`` moving the epoch's ingest to the device (a synchronous
copy of pageable host memory)."""
from harness import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "ingest_copy")
