"""Host-side cryptography of the port."""
