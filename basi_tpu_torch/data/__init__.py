"""Host-side batch preparation and on-device mask unpacking."""
