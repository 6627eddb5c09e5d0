"""Native host runtime: PNG decode and the threaded stereo prefetcher (C++,
built with g++ at first use, bound with ctypes)."""
