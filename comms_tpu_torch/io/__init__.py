"""I/O: raw IQ files (``raw_iq``), the socket transport (``net``) and its
CBOR codec (``cbor``)."""
