// libgpumounter_native: the port's native /proc holder scan, a C ABI for
// ctypes (gpumounter_tpu_torch/native/__init__.py).
//
// The counterpart of the reference's tpm_scan_device_holders
// (native/tpumounter_native.cpp), which stands in for the original's NVML
// process query (GetComputeRunningProcesses, nvml.go:33-52): the busy check
// of every unmount. The plain version, which tests hold this one against, is
// scan_proc_for_device_plain in gpumounter_tpu_torch/device/backend.py.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <dirent.h>
#include <limits.h>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <unistd.h>

namespace {

bool all_digits(const char* s) {
  if (*s == '\0') return false;
  for (; *s; ++s)
    if (*s < '0' || *s > '9') return false;
  return true;
}

}  // namespace

extern "C" {

// The PIDs under `proc_root` with an open fd on the device: a char device of
// rdev want_major:want_minor (when both are >= 0 and not 0:0), or an fd whose
// link target is exactly `path_hint` (when it is not empty). Writes at most
// max_out PIDs to out_pids and returns how many there are, which may be
// more (the caller calls again with a larger buffer), or -errno when
// proc_root cannot be read.
int gpm_scan_device_holders(int64_t want_major, int64_t want_minor, const char* path_hint,
                            const char* proc_root, int32_t* out_pids, int max_out) {
  DIR* proc = opendir(proc_root);
  if (proc == nullptr) return -errno;
  bool match_rdev = want_major >= 0 && want_minor >= 0 && (want_major | want_minor) != 0;
  dev_t want_rdev = match_rdev ? makedev(static_cast<unsigned>(want_major),
                                         static_cast<unsigned>(want_minor))
                               : 0;
  bool match_path = path_hint != nullptr && *path_hint != '\0';
  int count = 0;
  while (struct dirent* pent = readdir(proc)) {
    if (!all_digits(pent->d_name)) continue;
    char fd_dir_path[PATH_MAX];
    if (std::snprintf(fd_dir_path, sizeof(fd_dir_path), "%s/%s/fd", proc_root, pent->d_name) >=
        static_cast<int>(sizeof(fd_dir_path)))
      continue;
    DIR* fd_dir = opendir(fd_dir_path);
    if (fd_dir == nullptr) continue;
    bool hit = false;
    while (!hit) {
      struct dirent* fent = readdir(fd_dir);
      if (fent == nullptr) break;
      if (fent->d_name[0] == '.') continue;
      char fd_path[PATH_MAX];
      if (std::snprintf(fd_path, sizeof(fd_path), "%s/%s", fd_dir_path, fent->d_name) >=
          static_cast<int>(sizeof(fd_path)))
        continue;
      if (match_rdev) {
        struct stat st{};
        hit = stat(fd_path, &st) == 0 && S_ISCHR(st.st_mode) && st.st_rdev == want_rdev;
      }
      if (!hit && match_path) {
        char link[PATH_MAX + 1];
        ssize_t n = readlink(fd_path, link, sizeof(link));
        // a target as long as the buffer may be cut short: no exact match
        if (n > 0 && n < static_cast<ssize_t>(sizeof(link))) {
          link[n] = '\0';
          hit = std::strcmp(link, path_hint) == 0;
        }
      }
    }
    closedir(fd_dir);
    if (hit) {
      if (count < max_out)
        out_pids[count] = static_cast<int32_t>(std::strtol(pent->d_name, nullptr, 10));
      count++;
    }
  }
  closedir(proc);
  return count;
}

}  // extern "C"
