"""Native (C++) ingest stage: libav demux and decode behind a ctypes binding
(`native`), built at first use."""
