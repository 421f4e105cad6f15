"""The serving layer of the port: the stream server and its socket front
door, and the wmix daemon (core, tasks, control plane, HALs, client, CLI)
with the bridge that serves many daemons' record chains from one batch.

The wire protocol (SysV message queues keyed by ftok(sysv.MSG_PATH, 'w'),
the WMix_Msg layout, per-task queues under MSG_PATH, shared-memory mic
rings 'I'/'L') is `wmix_tpu`'s and the C reference's, so clients of either
drive this daemon."""
