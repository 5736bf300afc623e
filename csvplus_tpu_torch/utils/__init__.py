"""Host helpers: positional checksums, the relay iterator, Go JSON encoding."""
