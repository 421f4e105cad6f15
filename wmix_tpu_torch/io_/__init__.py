"""Host-side transport/IPC layer: RTP over UDP, FIFO and shared-memory
stream fan-out — the daemon's L5 transport re-hosted around the batched
device engine."""
