"""Standalone test tools (reference L9, tools/): RTP stream push/pull
CLIs for manual end-to-end testing against the daemon or VLC."""
