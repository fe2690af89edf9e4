"""Data: synthetic batches, the transcript tokenizer, the LRW video readers
(pkl trees and packed), the threaded loader and the loader factory."""
