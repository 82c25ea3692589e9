// Shared helpers for the native runtime.
//
// Reference parity: paddle/fluid/framework/channel.h (ChannelObject),
// blocking_queue.h, recordio/{header,chunk,writer,scanner}.h,
// framework/data_feed.cc (MultiSlotDataFeed), framework/io/shell.cc.
// Re-designed as a small C API consumed from Python via ctypes (the
// reference exposes these through pybind; SURVEY.md §7: native where the
// reference is native and XLA doesn't subsume it).
#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {
// every buffer handed to Python is malloc'd and released with pt_free
void pt_free(void* p);
}
