// Native IO: multithreaded bulk file reads for checkpoint loading.
//
// Analog of the reference's weight-IO layer
// (/root/reference/src/fastertransformer/utils/memory_utils.cu
// loadWeightFromBin*): the reference's headline feature #5 is "higher model
// load speed" (README.md:36); here the Python loader hands every .bin file's
// (path, destination buffer) to this library, which fans the preads across a
// thread pool with large block reads — no Python allocator or GIL on the path.
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Read each paths[i] fully into dests[i] (sizes[i] bytes). Returns 0 on
// success, or 1-based index of the first failing file.
int ftcf_read_files(const char** paths, void** dests, const int64_t* sizes,
                    int n, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      int fd = open(paths[i], O_RDONLY);
      if (fd < 0) {
        failed.store(i + 1);
        return;
      }
      char* dst = static_cast<char*>(dests[i]);
      int64_t remaining = sizes[i];
      int64_t off = 0;
      while (remaining > 0) {
        ssize_t got = pread(fd, dst + off, remaining, off);
        if (got <= 0) {
          failed.store(i + 1);
          break;
        }
        off += got;
        remaining -= got;
      }
      close(fd);
    }
  };

  std::vector<std::thread> pool;
  int nt = std::min(threads, n);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load();
}

// Convenience: file size (or -1).
int64_t ftcf_file_size(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  int64_t s = ftell(f);
  fclose(f);
  return s;
}

}  // extern "C"
