// gpumounter-nsexec: enter a process's mount namespace and run a batch of
// device-node operations there, with direct syscalls and no shell.
//
// The port's counterpart of the reference's helper (native/nsexec.cpp), in
// the port's batched form: one exec and one setns(2) for every node of a
// mount or a remove. It replaces the original's
//   nsenter --target PID --mount sh -c "mknod -m 666 /dev/nvidiaN c 195 N"
// (pkg/util/namespace/namespace.go:167-189), which needs sh and mknod inside
// the target container. The plain version, which tests hold this one
// against, is gpumounter_tpu_torch/nsutil/nsexec.py: the same argv, the same
// ops, the same report.
//
// Usage (argv only):
//   gpumounter-nsexec NS_PATH [OP...]
//   OP:  mknod PATH MAJOR MINOR MODE   a char device (MODE octal), missing
//                                      parents made 0755; idempotent
//        unlink PATH                   a missing node is fine
//        missing N PATH1..PATHN        reports the paths that do not exist
// NS_PATH is a mount namespace, /proc/PID/ns/mnt. The last line of stdout is
//   {"results": [...]}                 one entry an op: null, or the list
// or, on a failure, with exit code 1,
//   {"stage": "enter"|"op", "errno": E, "strerror": "...", "filename": "...",
//    "message": "<call or op> <filename>: <strerror>"}
// A malformed argv prints the usage on stderr and exits 2.

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sched.h>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

enum class Kind { kMknod, kUnlink, kMissing };

struct Op {
  Kind kind;
  const char* path = nullptr;
  unsigned long major_num = 0, minor_num = 0, mode = 0;
  std::vector<const char*> paths;  // kMissing
};

[[noreturn]] void usage(const char* why) {
  std::fprintf(stderr,
               "gpumounter-nsexec: %s\n"
               "usage: gpumounter-nsexec NS_PATH [mknod PATH MAJOR MINOR MODE | "
               "unlink PATH | missing N PATH...]...\n",
               why);
  std::exit(2);
}

// Digits of `base` only, at most `max`; anything else is a usage error.
unsigned long parse_number(const char* s, int base, unsigned long max, const char* what) {
  if (*s == '\0') usage(what);
  unsigned long v = 0;
  for (const char* p = s; *p; ++p) {
    int digit = *p - '0';
    if (digit < 0 || digit >= base) usage(what);
    v = v * base + digit;
    if (v > max) usage(what);
  }
  return v;
}

std::vector<Op> parse_ops(int argc, char** argv) {
  std::vector<Op> ops;
  int i = 0;
  while (i < argc) {
    const char* name = argv[i];
    Op op{};
    if (std::strcmp(name, "mknod") == 0 && i + 5 <= argc) {
      op.kind = Kind::kMknod;
      op.path = argv[i + 1];
      op.major_num = parse_number(argv[i + 2], 10, 0xffffffffUL, "bad major");
      op.minor_num = parse_number(argv[i + 3], 10, 0xffffffffUL, "bad minor");
      op.mode = parse_number(argv[i + 4], 8, 07777, "bad mode");
      i += 5;
    } else if (std::strcmp(name, "unlink") == 0 && i + 2 <= argc) {
      op.kind = Kind::kUnlink;
      op.path = argv[i + 1];
      i += 2;
    } else if (std::strcmp(name, "missing") == 0 && i + 2 <= argc) {
      op.kind = Kind::kMissing;
      unsigned long n = parse_number(argv[i + 1], 10, argc - i - 2, "bad count");
      op.paths.assign(argv + i + 2, argv + i + 2 + n);
      i += 2 + static_cast<int>(n);
    } else {
      usage("bad op");
    }
    ops.push_back(op);
  }
  return ops;
}

// `s` as a JSON string. Bytes from 0x80 up pass as they are: a path that is
// UTF-8 stays UTF-8, and the caller decodes any other byte as it decodes
// its own paths.
std::string json_string(const char* s) {
  std::string out = "\"";
  for (const unsigned char* p = reinterpret_cast<const unsigned char*>(s); *p; ++p) {
    switch (*p) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      default:
        if (*p < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", *p);
          out += buf;
        } else {
          out += static_cast<char>(*p);
        }
    }
  }
  return out + "\"";
}

[[noreturn]] void fail(const char* stage, const char* what, const std::string& filename,
                       int err) {
  const char* reason = std::strerror(err);
  std::string message = std::string(what) + " " + filename + ": " + reason;
  std::printf("{\"stage\": \"%s\", \"errno\": %d, \"strerror\": %s, \"filename\": %s, "
              "\"message\": %s}\n",
              stage, err, json_string(reason).c_str(), json_string(filename.c_str()).c_str(),
              json_string(message.c_str()).c_str());
  std::exit(1);
}

bool exists(const char* path) {
  struct stat st{};
  return stat(path, &st) == 0;
}

// Each missing parent directory of `path`, mode 0755, from the top. On a
// failure, returns errno and sets `failed` to the directory.
int mkdir_parents(const std::string& path, std::string* failed) {
  for (size_t i = 1; i < path.size(); ++i) {
    if (path[i] != '/') continue;
    std::string dir = path.substr(0, i);
    if (mkdir(dir.c_str(), 0755) != 0 && errno != EEXIST) {
      *failed = dir;
      return errno;
    }
  }
  return 0;
}

// A char device node, parents included; idempotent. The mode is set again
// with chmod: the umask masks mknod's.
int mknod_here(const Op& op, std::string* failed) {
  if (exists(op.path)) return 0;
  if (int err = mkdir_parents(op.path, failed)) return err;
  dev_t dev = makedev(static_cast<unsigned>(op.major_num), static_cast<unsigned>(op.minor_num));
  mode_t mode = static_cast<mode_t>(op.mode);
  if (mknod(op.path, mode | S_IFCHR, dev) != 0) {
    if (errno == EEXIST) return 0;  // two GPUs injecting one companion: the loser is fine
    *failed = op.path;
    return errno;
  }
  if (chmod(op.path, mode) != 0) {
    *failed = op.path;
    return errno;
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) usage("no namespace path");
  const char* ns_path = argv[1];
  std::vector<Op> ops = parse_ops(argc - 2, argv + 2);

  int fd = open(ns_path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) fail("enter", "open", ns_path, errno);
  if (setns(fd, CLONE_NEWNS) != 0) fail("enter", "setns", ns_path, errno);
  close(fd);

  std::string results;
  for (const Op& op : ops) {
    if (!results.empty()) results += ", ";
    std::string failed;
    if (op.kind == Kind::kMknod) {
      if (int err = mknod_here(op, &failed)) fail("op", "mknod", failed, err);
      results += "null";
    } else if (op.kind == Kind::kUnlink) {
      if (unlink(op.path) != 0 && errno != ENOENT) fail("op", "unlink", op.path, errno);
      results += "null";
    } else {
      std::string missing;
      for (const char* path : op.paths) {
        if (exists(path)) continue;
        missing += (missing.empty() ? "" : ", ") + json_string(path);
      }
      results += "[" + missing + "]";
    }
  }
  std::printf("{\"results\": [%s]}\n", results.c_str());
  return 0;
}
