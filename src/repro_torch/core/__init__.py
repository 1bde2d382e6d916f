"""Host-side runtime pieces: device resolution and the dispatch queue."""
